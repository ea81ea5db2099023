"""`equalize_hist256`, K1 `histogram256`, K2 `apply_lut256`, `equalize_hist`
and the `refine_lm` wrapper.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held exactly (integer counts, integer LUT values) against the JAX
package's Pallas kernels run in interpret mode (patched as
tests/test_pallas_kernels.py does), against its plain versions and
against numpy. `refine_lm` on the CPU is its plain version (the
JAX comparison is tests/test_torch_pnp.py's). The CUDA kernels
themselves run only on the card: tests/test_torch_cuda.py compares them
with the plain versions there.
"""

import ast
import functools
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import kernels
from slam3d_gx_torch.kernels import refine_lm as tlm
from slam3d_gx_torch.ops import imageproc as timg
from slam3d_gx_torch.ops import pnp as tpnp
from slam3d_gx_tpu.ops import imageproc as jimg
from slam3d_gx_tpu.ops import pallas_kernels as jpk

REPO = pathlib.Path(__file__).resolve().parents[1]


def interpret(fn, *args):
    from jax.experimental import pallas

    orig = pallas.pallas_call
    try:
        pallas.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(fn(*args))
    finally:
        pallas.pallas_call = orig


def images():
    rng = np.random.default_rng(3)
    skewed = np.clip(rng.normal(40, 6, (48, 64)), 0, 255).astype(np.uint8)
    holes = rng.choice([0, 17, 18, 200, 255], (33, 47)).astype(np.uint8)
    return {
        "random": rng.integers(0, 256, (48, 64)).astype(np.uint8),
        "constant": np.full((31, 29), 93, np.uint8),
        "skewed": skewed,
        "empty_bins": holes,
        "one_pixel": np.array([[7]], np.uint8),
        "ragged": rng.integers(0, 256, (37, 53)).astype(np.uint8),
    }


@pytest.mark.parametrize("name", sorted(images()))
def test_histogram256_plain_matches_pallas_and_numpy(name):
    img = images()[name]
    port = kernels.histogram256(torch.from_numpy(img))
    assert port.dtype == torch.int32 and port.shape == (256,)
    ref_np = np.bincount(img.reshape(-1).astype(np.int64), minlength=256)
    np.testing.assert_array_equal(port.numpy(), ref_np)
    ref_pallas = interpret(jpk._histogram256_pallas, jnp.asarray(img.reshape(-1), jnp.float32))
    np.testing.assert_array_equal(port.numpy(), ref_pallas.astype(np.int64))
    # the JAX-style f32 input holding integers gives the same counts
    np.testing.assert_array_equal(
        kernels.histogram256(torch.from_numpy(img.astype(np.float32))).numpy(), ref_np)


@pytest.mark.parametrize("name", sorted(images()))
def test_apply_lut256_plain_matches_pallas_and_numpy(name):
    img = images()[name]
    rng = np.random.default_rng(4)
    lut = np.sort(rng.integers(0, 256, 256)).astype(np.float32)
    port = kernels.apply_lut256(torch.from_numpy(img), torch.from_numpy(lut))
    assert port.dtype == torch.uint8 and port.shape == img.shape
    np.testing.assert_array_equal(port.numpy(), lut[img.astype(np.int64)].astype(np.uint8))
    ref_pallas = interpret(jpk._apply_lut256_pallas,
                           jnp.asarray(img.reshape(-1), jnp.float32), jnp.asarray(lut))
    np.testing.assert_array_equal(port.numpy().reshape(-1), ref_pallas.astype(np.uint8))


def equalize_images():
    """`images()` and the corners of the LUT arithmetic."""
    one = np.zeros((24, 40), np.uint8)
    one[5, 7] = 9
    # total - first count = 510: scale is 0.5 and every odd cumulative
    # count lands on a .5 tie (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, ...)
    ties = np.concatenate([[0, 0, 1], np.repeat(np.arange(2, 256), 2), [255]])
    rng = np.random.default_rng(12)
    return dict(images(), one_nonzero_pixel=one,
                total_minus_first_is_one=np.where(one > 0, 200, 31).astype(np.uint8),
                half_ties=rng.permutation(ties).reshape(16, 32).astype(np.uint8))


def cv_equalize_hist(img):
    """cv::equalizeHist, transcribed: float scale, float product, cvRound
    (half to even), saturate to uint8; a constant image is returned."""
    hist = np.bincount(img.reshape(-1), minlength=256)
    i = int(np.nonzero(hist)[0][0])
    if hist[i] == img.size:
        return img.copy()
    scale = np.float32(255.0) / np.float32(img.size - hist[i])
    lut = np.zeros(256, np.uint8)
    total = 0
    for j in range(i + 1, 256):
        total += int(hist[j])
        lut[j] = np.clip(np.rint(np.float32(total) * scale), 0, 255)
    return lut[img]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name", sorted(equalize_images()))
def test_equalize_hist256_matches_jax_pallas_and_opencv(name, dtype, monkeypatch):
    """Tolerance 0: counts and LUT entries are integers, and the LUT's two
    float32 operations (a division, a product) are single IEEE
    operations in every version, rounded half to even."""
    img = equalize_images()[name]
    want = cv_equalize_hist(img)
    x = torch.from_numpy(img.astype(dtype))
    for port in (kernels.equalize_hist256(x), timg.equalize_hist(x),
                 kernels.equalize.equalize_hist256_plain(x)):
        assert port.dtype == torch.uint8 and port.shape == img.shape
        np.testing.assert_array_equal(port.numpy(), want)
    # the JAX package with its two Pallas kernels in interpret mode
    monkeypatch.setattr(jpk, "histogram256", functools.partial(jpk.histogram256, use_pallas=True))
    monkeypatch.setattr(jpk, "apply_lut256", functools.partial(jpk.apply_lut256, use_pallas=True))
    ref = interpret(jimg.equalize_hist, jnp.asarray(img.astype(dtype)))
    np.testing.assert_array_equal(ref, want)


def test_equalize_half_ties_round_to_even():
    img = equalize_images()["half_ties"]
    lut = timg.equalize_lut(kernels.histogram256(torch.from_numpy(img)), img.size)
    np.testing.assert_array_equal(lut[:6].numpy(), [0, 0, 2, 2, 4, 4])


@pytest.mark.parametrize("name", sorted(images()))
def test_equalize_hist_matches_jax(name):
    img = images()[name]
    port = timg.equalize_hist(torch.from_numpy(img))
    ref = np.asarray(jimg.equalize_hist(jnp.asarray(img)))
    assert port.dtype == torch.uint8
    np.testing.assert_array_equal(port.numpy(), ref)
    # the JAX-style float input of the extractor gives the same image
    np.testing.assert_array_equal(
        timg.equalize_hist(torch.from_numpy(img.astype(np.float32))).numpy(), ref)


def test_equalize_constant_image_is_identity_through_the_lut():
    hist = kernels.histogram256(torch.full((5, 7), 200, dtype=torch.uint8))
    lut = timg.equalize_lut(hist, 35)
    np.testing.assert_array_equal(lut.numpy(), np.arange(256, dtype=np.float32))


def test_plane_membership_images_match_jax():
    rng = np.random.default_rng(5)
    H, W = 30, 40
    xyz = rng.uniform([-1, -1, 0.5], [1, 1, 4], (H, W, 3)).astype(np.float32)
    xyz[:10, :, 2] = 2.0  # a band on the plane z = 2
    xyz[20:, :, 1] = 0.8  # a band on the plane y = 0.8
    valid = rng.random((H, W)) > 0.1
    coeffs = np.array([[0, 0, -1, 2.0], [0, 1, 0, -0.8], [0, 0, 1, 0]], np.float32)
    plane_valid = np.array([True, True, False])
    gray = rng.integers(0, 256, (H, W)).astype(np.uint8)
    ref_img, ref_mask = jimg.plane_membership_images(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(coeffs),
        jnp.asarray(plane_valid), jnp.asarray(gray), 0.08)
    port_img, port_mask = timg.plane_membership_images(
        torch.from_numpy(xyz), torch.from_numpy(valid), torch.from_numpy(coeffs),
        torch.from_numpy(plane_valid), torch.from_numpy(gray), 0.08)
    np.testing.assert_array_equal(port_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(port_img.numpy(), np.asarray(ref_img))
    assert port_mask[0].sum() > 0 and port_mask[1].sum() > 0


def test_wrappers_count_only_kernel_launches():
    kernels.reset_counts()
    img = torch.from_numpy(images()["random"])
    timg.equalize_hist(img)
    kernels.equalize_hist256(img)
    assert kernels.launch_counts() == {"equalize_hist256": 0, "histogram256": 0,
                                       "apply_lut256": 0, "min_eig_response": 0,
                                       "refine_lm": 0}


def test_wrappers_refuse_a_device_without_a_kernel():
    meta = torch.zeros(16, dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.histogram256(meta)
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.apply_lut256(meta, torch.zeros(256, device="meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.equalize_hist256(meta)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tlm.refine_lm(*(a.to("meta") for a in lm_problem(8, None)), *LM_CAM)


def test_wrappers_have_no_fallback_from_the_kernel():
    """On a CUDA tensor the wrapper launches the kernel or raises: no
    `try` around the launch may route to the plain version."""
    for module in ("equalize.py", "min_eig.py", "refine_lm.py"):
        tree = ast.parse((REPO / "slam3d_gx_torch" / "kernels" / module).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], module


def c_entries(source: str) -> dict:
    """{name: [ctypes type of each parameter]} of every `extern "C"` entry
    in a CUDA source: a pointer is c_void_p, then long long, int, float."""
    import ctypes
    import re

    def ctype(param):
        if "*" in param:
            return ctypes.c_void_p
        if "long long" in param:
            return ctypes.c_longlong
        return {"int": ctypes.c_int, "float": ctypes.c_float}[param.split()[0]]

    return {m.group(1): [ctype(p.strip()) for p in m.group(2).split(",") if p.strip()]
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', source)}


@pytest.mark.parametrize("module", ["equalize", "min_eig", "refine_lm"])
def test_wrapper_types_every_c_entry_as_its_source_declares(module):
    """ctypes passes an argument left out of `argtypes` by its default
    conversion (a Python int as a 32-bit int), so a stream handle the list
    forgets reaches the kernel with its upper half unset. Each wrapper
    types every parameter of every C entry of its source, in order."""
    import importlib

    mod = importlib.import_module(f"slam3d_gx_torch.kernels.{module}")
    source = (REPO / "slam3d_gx_torch" / "csrc" / f"{mod.SOURCE}.cu").read_text()
    declared = c_entries(source)
    assert declared and mod._ARGTYPES == declared


def test_built_library_is_named_after_its_source_and_flags(monkeypatch):
    """An edited source must never be answered with a stale library."""
    from slam3d_gx_torch.kernels import build

    a = build.lib_path("equalize", "__global__ void k() {}")
    assert a == build.lib_path("equalize", "__global__ void k() {}")
    assert a != build.lib_path("equalize", "__global__ void k() { }")
    assert a != build.lib_path("min_eig", "__global__ void k() {}")
    assert pathlib.Path(a).parent == pathlib.Path(build.BUILD_DIR)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert a != build.lib_path("equalize", "__global__ void k() {}")


LM_CAM = (260.0, 260.0, 160.0, 120.0)


def lm_problem(n, G, seed=4):
    """(rvec, tvec, obj, img, weights) float32: a start 0.03 off a pose
    that explains the pixels to 0.3 px; G=None for one problem."""
    rng = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    obj = rng.uniform([-1, -1, 2], [1, 1, 4], lead + (n, 3))
    img = obj[..., :2] / obj[..., 2:] * 260.0 + [160.0, 120.0]
    img = img + rng.normal(0, 0.3, img.shape)
    w = (rng.random(lead + (n,)) > 0.2)
    rv = rng.normal(0, 0.03, lead + (3,))
    tv = rng.normal(0, 0.03, lead + (3,))
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (rv, tv, obj, img, w))


@pytest.mark.parametrize("G", [None, 3])
@pytest.mark.parametrize("iters", [0, 4])
def test_refine_lm_on_the_cpu_is_its_plain_version(G, iters):
    """Bit for bit, through the wrapper and through ops.pnp.refine_pnp,
    and no launch counted."""
    args = lm_problem(64, G)
    kernels.reset_counts()
    want = tlm.refine_lm_plain(*args, *LM_CAM, iters=iters)
    for got in (tlm.refine_lm(*args, *LM_CAM, iters=iters),
                tpnp.refine_pnp(*args, *LM_CAM, iters=iters)):
        for a, b in zip(got, want):
            assert a.shape == b.shape == ((3,) if G is None else (G, 3))
            assert torch.equal(a, b)
    assert kernels.launch_counts()["refine_lm"] == 0


@pytest.mark.parametrize("bad", ["float64", "batch_rank_2", "shapes_disagree"])
def test_refine_lm_refuses_what_it_does_not_take(bad):
    rv, tv, obj, img, w = lm_problem(16, 2)
    if bad == "float64":
        obj = obj.double()
        err, match = TypeError, "float32"
    elif bad == "batch_rank_2":
        rv, tv, obj, img, w = (a[None] for a in (rv, tv, obj, img, w))
        err, match = ValueError, r"\(N,3\) or \(G,N,3\)"
    else:
        w = w[:, :-1]
        err, match = ValueError, "weights must be"
    kernels.reset_counts()
    with pytest.raises(err, match=match):
        tlm.refine_lm(rv, tv, obj, img, w, *LM_CAM)
    assert kernels.launch_counts()["refine_lm"] == 0
