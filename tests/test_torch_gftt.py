"""K3's plain version, GFTT and HARRIS against the JAX package.

On the CPU the port's `min_eig_response` runs its plain PyTorch version;
it is held against `harris.min_eig_response` and against the Pallas
kernel `_min_eig_kernel` in interpret mode (patched as
tests/test_pallas_kernels.py does). The CUDA kernel itself runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances and why:
- response maps: the plain version follows the reference's order of
  operations (Sobel taps row-major; box rows, then columns, then /9), so
  against `harris.min_eig_response` only XLA:CPU's own fusing (FMA
  contraction, a sqrt that is not correctly rounded) can move a last
  bit of the box sums: 2e-6 of the map's largest box sum, which bounds
  the cancellation in `tr/2 - sqrt(...)`. On integer images every sum
  is exact in fp32 and the bound is the same. The Pallas kernel sums
  the box's 9 taps in another order: the repo's own tolerance for it,
  rtol 1e-5 and atol 1e-3 (tests/test_pallas_kernels.py:79), scaled to
  the image (atol 1e-3 holds for its +-50 image; here atol is 1e-6 of
  the largest box sum, which is the same size there);
- keypoints are compared as sets, because top-k orders equal responses
  differently; a keypoint within 1e-4 (relative) of the quality gate may
  be valid in one package only, and none is in these images.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import kernels
from slam3d_gx_torch.kernels import min_eig as tk3
from slam3d_gx_torch.ops.features import harris as tharris
from slam3d_gx_torch.ops.features import registry as treg
from slam3d_gx_tpu.ops import pallas_kernels as jpk
from slam3d_gx_tpu.ops.features import harris as jharris
from slam3d_gx_tpu.ops.features import registry as jreg
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.testing import synthetic

INTR = CameraIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)


def interpret(fn, *args, **kw):
    from jax.experimental import pallas

    orig = pallas.pallas_call
    try:
        pallas.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(fn(*args, **kw))
    finally:
        pallas.pallas_call = orig


def images():
    rng = np.random.default_rng(7)
    return {
        "48x200": (rng.normal(size=(48, 200)) * 50).astype(np.float32),
        "37x53": (rng.normal(size=(37, 53)) * 50).astype(np.float32),
        "1xW": (rng.normal(size=(1, 23)) * 50).astype(np.float32),
        "Hx1": (rng.normal(size=(19, 1)) * 50).astype(np.float32),
        "constant": np.full((21, 34), 93.0, np.float32),
        "integer": rng.integers(0, 256, (40, 72)).astype(np.float32),
    }


def scale(img):
    """The largest box sum the response is a difference of."""
    sxx, syy, _ = tk3.structure_tensor(torch.from_numpy(img))
    return max(float((sxx + syy).max()), 1.0)


@pytest.mark.parametrize("name", sorted(images()))
def test_min_eig_plain_matches_jax_and_pallas(name):
    img = images()[name]
    port = kernels.min_eig_response(torch.from_numpy(img))
    assert port.dtype == torch.float32 and port.shape == img.shape
    s = scale(img)
    ref = np.asarray(jharris.min_eig_response(jnp.asarray(img)))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=2e-6 * s)
    ref_pallas = interpret(jpk.min_eig_response_fused, jnp.asarray(img), use_pallas=True)
    np.testing.assert_allclose(port.numpy(), ref_pallas, rtol=1e-5, atol=1e-6 * s)
    # the wrapper's other input type: uint8 holding the same integers
    if name in ("constant", "integer"):
        np.testing.assert_array_equal(
            kernels.min_eig_response(torch.from_numpy(img.astype(np.uint8))).numpy(),
            port.numpy())


def test_min_eig_corners_replicate_the_gradients_not_the_image():
    """At a corner both clamps bite: the box reads the gradient at the
    clamped position, not a Sobel of a doubly padded image (whose gy
    would vanish at row -1)."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (6, 7)).astype(np.float32)
    port = kernels.min_eig_response(torch.from_numpy(img)).numpy()
    pad = np.pad(img, 1, mode="edge")
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    for dy in range(3):
        for dx in range(3):
            gx += kx[dy, dx] * pad[dy:dy + 6, dx:dx + 7]
            gy += kx.T[dy, dx] * pad[dy:dy + 6, dx:dx + 7]

    def box(a):
        p = np.pad(a, 1, mode="edge")
        return sum(p[dy:dy + 6, dx:dx + 7] for dy in range(3) for dx in range(3)) / 9.0

    sxx, syy, sxy = box(gx * gx), box(gy * gy), box(gx * gy)
    want = (sxx + syy) / 2 - np.sqrt(((sxx - syy) / 2) ** 2 + sxy ** 2)
    np.testing.assert_allclose(port, want, rtol=0, atol=2e-6 * scale(img))
    doubly = np.pad(img, 2, mode="edge")  # the wrong border, for contrast
    gy_wrong_row = doubly[2, 2:-2] - doubly[0, 2:-2]
    assert not gy_wrong_row.any() and gy[0].any()


def test_harris_response_matches_jax():
    for name in ("48x200", "integer"):
        img = images()[name]
        port = tharris.harris_response(torch.from_numpy(img)).numpy()
        ref = np.asarray(jharris.harris_response(jnp.asarray(img)))
        # det - k tr^2 is a difference of products of box sums
        np.testing.assert_allclose(port, ref, rtol=0, atol=4e-6 * scale(img) ** 2)


@pytest.fixture(scope="module")
def frame():
    scene = synthetic.RoomScene(seed=3)
    pose = synthetic.orbit_trajectory(4, radius=0.2, yaw_amp=0.1)[1]
    gray, _ = synthetic.render_frame(scene, pose, INTR, 120, 160)
    return gray


def kp_rows(kps):
    """Valid keypoints as rows (u, v, response), sorted by position."""
    v = np.asarray(kps.valid).astype(bool)
    rows = np.c_[np.asarray(kps.uv)[v], np.asarray(kps.response)[v]]
    return rows[np.lexsort(rows[:, :2].T[::-1])]


@pytest.mark.parametrize("name", ["GFTT", "HARRIS"])
def test_detectors_give_the_reference_keypoint_sets(frame, name):
    K = 64
    ref = jreg.create_detector(name, K, unbatched=True)(jnp.asarray(frame))
    port = treg.create_detector(name, K)(torch.from_numpy(frame))
    r, p = kp_rows(ref), kp_rows(port)
    assert len(r) == len(p) and len(r) > K // 2
    np.testing.assert_array_equal(p[:, :2], r[:, :2])
    np.testing.assert_allclose(p[:, 2], r[:, 2], rtol=1e-5)
    np.testing.assert_array_equal(port.size.numpy(), np.full(K, 7.0, np.float32))
    assert not port.angle.any()
    # none of these sits at the quality gate, where the packages may differ
    resp = np.asarray(ref.response)[np.asarray(ref.valid)]
    gate = 0.01 * float(np.asarray(
        jharris.harris_response(jnp.asarray(frame, jnp.float32)) if name == "HARRIS"
        else jharris.min_eig_response(jnp.asarray(frame, jnp.float32))).max())
    assert np.all(np.abs(resp - gate) > 1e-4 * gate)


def test_detector_mask_form_matches_jax(frame):
    mask = np.zeros(frame.shape, bool)
    mask[:, : frame.shape[1] // 2] = True
    ref = jreg.create_detector("GFTT", 64)(jnp.asarray(frame), jnp.asarray(mask))
    port = treg.create_detector("GFTT", 64)(torch.from_numpy(frame), torch.from_numpy(mask))
    np.testing.assert_array_equal(kp_rows(port)[:, :2], kp_rows(ref)[:, :2])
    assert 0 < int(port.valid.sum()) < 64


def test_constant_image_has_no_keypoint():
    img = torch.full((32, 40), 117, dtype=torch.uint8)
    assert not kernels.min_eig_response(img).any()
    kps = tharris.detect_gftt(img, max_kp=16)
    assert not kps.valid.any()


def test_nms_keeps_plateaus_and_the_gate_cuts_them():
    """NMS is >=, so two equal neighbouring maxima both survive it; only
    `response > thresh` removes keypoints."""
    img = np.zeros((24, 24), np.float32)
    img[8:16, 8:16] = 200.0  # a square: four equal corners
    kps = tharris.detect_gftt(torch.from_numpy(img), max_kp=32)
    ref = jharris.detect_gftt(jnp.asarray(img), max_kp=32)
    np.testing.assert_array_equal(kp_rows(kps)[:, :2], kp_rows(ref)[:, :2])
    assert int(kps.valid.sum()) >= 4


def test_registry_builds_gftt_and_harris():
    for name in ("GFTT", "gftt", "HARRIS"):
        assert callable(treg.create_detector(name, 16))
    with pytest.raises(ValueError):
        treg.create_descriptor("GFTT")  # a detector name only, as in the reference


def test_wrapper_counts_only_kernel_launches_and_checks_its_input():
    kernels.reset_counts()
    kernels.min_eig_response(torch.zeros(4, 5))
    assert kernels.launch_counts()["min_eig_response"] == 0
    with pytest.raises(ValueError, match="non-empty"):
        kernels.min_eig_response(torch.zeros(0, 5))
    with pytest.raises(ValueError, match="non-empty"):
        kernels.min_eig_response(torch.zeros(3, 4, 5))
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.min_eig_response(torch.zeros(4, 5, device="meta"))
