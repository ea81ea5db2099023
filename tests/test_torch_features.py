"""Parity of the port's SIFT front end and matcher with the JAX package.

Inputs are synthetic frames (slam3d_gx_tpu.testing.synthetic, seeded) at
160x120 with 64 keypoints. Tolerances and why:
- keypoints are compared as sets of (u, v, size), because top-k orders
  equal responses differently (features/common.py:68-69); positions to
  1e-3 px, responses to 1e-5;
- descriptors are rounded to integers in 0-255 (sift_desc.py:176-180),
  so each entry of a matching keypoint's descriptor may differ by the
  rounding of one fp32 ulp: +-1;
- matching on those integer descriptors is exact: indices, validity
  and the good-match masks; the distances agree to one fp32 ulp
  (rtol 2e-7), because XLA:CPU's sqrt is not correctly rounded.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import interop
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.frontend import pipeline as tpipe
from slam3d_gx_torch.ops import match as tmatch
from slam3d_gx_torch.ops.features import common as tcommon
from slam3d_gx_torch.ops.features import dog as tdog
from slam3d_gx_torch.ops.features import registry as treg
from slam3d_gx_torch.ops.features import sift_desc as tdesc
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.frontend import pipeline as jpipe
from slam3d_gx_tpu.ops import match as jmatch
from slam3d_gx_tpu.ops.features import common as jcommon
from slam3d_gx_tpu.ops.features import dog as jdog
from slam3d_gx_tpu.ops.features import sift_desc as jdesc
from slam3d_gx_tpu.testing import synthetic

H, W, K = 120, 160, 64
INTR = CameraIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)
TINTR = TorchIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)


@pytest.fixture(scope="module")
def frame():
    scene = synthetic.RoomScene(seed=3)
    pose = synthetic.orbit_trajectory(4, radius=0.2, yaw_amp=0.1)[1]
    gray, depth = synthetic.render_frame(scene, pose, INTR, H, W)
    return gray, depth


def t(a):
    return torch.as_tensor(np.array(a))


def test_filters_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (H, W)).astype(np.float32)
    for port, ref in [
        (tcommon.gaussian_blur(t(img), 1.6), jcommon.gaussian_blur(jnp.asarray(img), 1.6)),
        (tcommon.box_filter(t(img), 2), jcommon.box_filter(jnp.asarray(img), 2)),
        (tcommon.nms(t(img), 1), jcommon.nms(jnp.asarray(img), 1)),
    ]:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)
    for port, ref in zip(tcommon.sobel_gradients(t(img)),
                         jcommon.sobel_gradients(jnp.asarray(img))):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)


def test_topk_keypoints_and_mask_match_jax():
    rng = np.random.default_rng(2)
    resp = rng.uniform(0, 1, (H, W)).astype(np.float32)
    port = tcommon.topk_keypoints(t(resp), K, threshold=0.5, border=3)
    ref = jcommon.topk_keypoints(jnp.asarray(resp), K, threshold=0.5, border=3)
    # distinct random responses: the order is the same too
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask = rng.random((H, W)) > 0.5
    np.testing.assert_array_equal(
        tcommon.apply_mask(port, t(mask)).valid.numpy(),
        np.asarray(jcommon.apply_mask(ref, jnp.asarray(mask)).valid))


def kp_rows(kps):
    """Valid keypoints as rows (u, v, size, response), sorted."""
    v = np.asarray(kps.valid).astype(bool)
    rows = np.c_[np.asarray(kps.uv)[v], np.asarray(kps.size)[v], np.asarray(kps.response)[v]]
    return rows[np.lexsort(rows[:, :3].T[::-1])]


def test_detect_sift_keypoint_sets(frame):
    gray, _ = frame
    ref = jdog.detect_sift(jnp.asarray(gray, jnp.float32), max_kp=K)
    port = tdog.detect_sift(t(gray.astype(np.float32)), max_kp=K)
    r, p = kp_rows(ref), kp_rows(port)
    assert len(r) == len(p) and len(r) > K // 2
    np.testing.assert_allclose(p[:, :3], r[:, :3], atol=1e-3)
    np.testing.assert_allclose(p[:, 3], r[:, 3], atol=1e-5)


def test_sift_descriptors_within_one(frame):
    gray, _ = frame
    kps = jdog.detect_sift(jnp.asarray(gray, jnp.float32), max_kp=K)
    ref = np.asarray(jdesc.sift_descriptors(jnp.asarray(gray), kps))
    port_kps = tcommon.Keypoints(*(t(a) for a in kps))
    port = tdesc.sift_descriptors(t(gray), port_kps).numpy()
    assert np.abs(port - ref).max() <= 1.0
    assert (port == ref).mean() > 0.99
    assert ref[np.asarray(kps.valid)].sum() > 0


def test_registry_carries_sift_only():
    """Every detector and descriptor name of the reference resolves, in
    any case; SIFT and its SURF_SIFT aliases give the SIFT descriptor;
    the match floors are as before; an unknown name raises ValueError."""
    for name in ("SIFT", "SURF", "STAR", "GFTT", "HARRIS", "FAST", "GridFAST", "GRIDFAST",
                 "ORB", "orb"):
        assert callable(treg.create_detector(name))
    for name in ("sift", "SURF_SIFT", "SURF-SIFT"):
        assert treg.create_descriptor(name) is tdesc.sift_descriptors
    for name in ("SURF", "ORB", "BRIEF"):
        assert callable(treg.create_descriptor(name))
    assert treg.match_floor("SIFT") == 0.0 and treg.match_floor("ORB") == 5.0
    assert treg.match_floor("BRIEF") == 5.0 and treg.match_floor("SURF") == 0.0
    for make in (treg.create_detector, treg.create_descriptor,
                 lambda n: treg.detect_and_describe(n, "SIFT"),
                 lambda n: treg.detect_and_describe("SIFT", n)):
        with pytest.raises(ValueError):
            make("NOPE")


def test_match_ops_exact():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 40, (48, 128)).astype(np.float32)
    b = np.concatenate([a[::2] + rng.integers(-1, 2, (24, 128)),
                        rng.integers(0, 40, (40, 128))]).astype(np.float32)
    b[30] = b[31]  # a tie: the first index wins in both
    va, vb = rng.random(48) > 0.1, rng.random(64) > 0.1
    np.testing.assert_allclose(tmatch.l2_distance_matrix(t(a), t(b)).numpy(),
                               np.asarray(jmatch.l2_distance_matrix(jnp.asarray(a), jnp.asarray(b))),
                               rtol=2e-7, atol=0)
    pi, pd, pv = tmatch.match_nn(t(a), t(va), t(b), t(vb))
    ri, rd, rv = jmatch.match_nn(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy()[pv.numpy()], np.asarray(ri)[np.asarray(rv)])
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=2e-7, atol=0)
    for floor in (0.0, 5.0):
        np.testing.assert_array_equal(
            tmatch.good_match_filter(pd, pv, floor=floor).numpy(),
            np.asarray(jmatch.good_match_filter(rd, rv, floor=floor)))
    ca = rng.normal(size=(3, 4)).astype(np.float32)
    cb = (ca[[2, 0, 1]] + rng.normal(0, 0.01, (3, 4))).astype(np.float32)
    pv3 = np.array([True, True, False])
    for port, ref in zip(tmatch.match_planes(t(ca), t(pv3), t(cb), t(np.ones(3, bool))),
                         jmatch.match_planes(jnp.asarray(ca), jnp.asarray(pv3),
                                             jnp.asarray(cb), jnp.asarray(np.ones(3, bool)))):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=2e-7, atol=0)


def test_plane_extractor_matches_jax(frame):
    """The whole frame-scope extractor, JAX jitted against the port, on
    one synthetic frame, with the reference's plane-RANSAC draws."""
    gray, depth = frame
    from slam3d_gx_tpu.ops import pointcloud as jpc

    xyz_img, valid_img = jpc.backproject(jnp.asarray(depth), INTR.fx, INTR.fy, INTR.cx,
                                         INTR.cy, INTR.factor)
    cloud = np.asarray(xyz_img).reshape(-1, 3)
    mask = np.asarray(valid_img).reshape(-1)
    hyp, planes = 32, 3
    key = jax.random.PRNGKey(2)
    extract_j = jpipe.build_plane_extractor("SIFT", "SIFT", INTR, max_kp=K,
                                            hypotheses=hyp, max_planes=planes)
    ref = extract_j(jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(cloud),
                    jnp.asarray(mask), key)
    n = min(cloud.shape[0] // max(1, cloud.shape[0] // tpipe.PLANE_POINTS),
            tpipe.PLANE_POINTS)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (hyp, 3, n), jnp.float32))
                       for k in jax.random.split(key, planes)])
    extract_t = tpipe.build_plane_extractor("SIFT", "SIFT", TINTR, max_kp=K,
                                            hypotheses=hyp, max_planes=planes)
    port = extract_t(t(gray), t(depth.astype(np.int32)), t(cloud), t(mask),
                     interop.plane_sampler(gumbel, "cpu"))
    ref_np = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    port_np = interop.features_to_numpy(port)
    np.testing.assert_array_equal(port_np["plane_valid"], ref_np["plane_valid"])
    np.testing.assert_allclose(port_np["coeffs"], ref_np["coeffs"], atol=1e-4)
    assert ref_np["plane_valid"].sum() >= 1
    for p in range(planes):
        kv_r, kv_p = ref_np["kp_valid"][p], port_np["kp_valid"][p]
        assert kv_r.sum() == kv_p.sum()
        if not kv_r.any():
            continue
        rows_r = np.c_[ref_np["uv"][p][kv_r], ref_np["kp3d"][p][kv_r], ref_np["desc"][p][kv_r]]
        rows_p = np.c_[port_np["uv"][p][kv_p], port_np["kp3d"][p][kv_p], port_np["desc"][p][kv_p]]
        rows_r = rows_r[np.lexsort(rows_r[:, :2].T[::-1])]
        rows_p = rows_p[np.lexsort(rows_p[:, :2].T[::-1])]
        np.testing.assert_allclose(rows_p[:, :2], rows_r[:, :2], atol=1e-3)
        np.testing.assert_allclose(rows_p[:, 2:5], rows_r[:, 2:5], atol=1e-3)
        assert np.abs(rows_p[:, 5:] - rows_r[:, 5:]).max() <= 1.0
