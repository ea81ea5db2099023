"""`equalize_hist256`, K1 `histogram256`, K2 `apply_lut256` and `equalize_hist`.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held exactly (integer counts, integer LUT values) against the JAX
package's Pallas kernels run in interpret mode (patched as
tests/test_pallas_kernels.py does), against its plain versions and
against numpy. The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py compares them with the plain versions there.
"""

import ast
import functools
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import kernels
from slam3d_gx_torch.ops import imageproc as timg
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
                                       "apply_lut256": 0, "min_eig_response": 0}


def test_wrappers_refuse_a_device_without_a_kernel():
    meta = torch.zeros(16, dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.histogram256(meta)
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.apply_lut256(meta, torch.zeros(256, device="meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.equalize_hist256(meta)


def test_wrappers_have_no_fallback_from_the_kernel():
    """On a CUDA tensor the wrapper launches the kernel or raises: no
    `try` around the launch may route to the plain version."""
    for module in ("equalize.py", "min_eig.py"):
        tree = ast.parse((REPO / "slam3d_gx_torch" / "kernels" / module).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], module


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
