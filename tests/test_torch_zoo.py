"""Parity of the port's detector and descriptor zoo with the JAX package.

Inputs are synthetic frames (slam3d_gx_tpu.testing.synthetic, seeded) at
160x120 with 64 keypoints, and one at 320x240. Tolerances and why:
- FAST and GridFAST: on integer images every tap difference and every
  score is an integer, so the score maps are exactly equal. Keypoints
  are compared as sets, because top-k orders equal scores differently;
  the GridFAST budget per cell is equal.
- SURF and STAR at 160x120: the f32 integral image of a uint8 frame is
  exact below 2^24 (here at most 160*120*255), so the response stacks
  agree to 1e-5 relative (the box arithmetic rounds alike) and the
  keypoint sets are equal. At 320x240 the integral's sums pass 2^24 and
  each package rounds them in its own order, so near-ties may go either
  way: the sets overlap by >= 95%.
- SURF-64 descriptor: both packages get the same keypoints; the vectors
  agree to 1e-5 (sums in another order).
- ORB: the test pattern equals the JAX package's bit for bit. The
  orientation bin of a keypoint agrees on >= 99% of them (the centroid's
  sums, in another order, can move atan2 across a 12-degree edge), and
  on every keypoint whose bin agrees, the 256 bits are equal: a one-hot
  row at HIGHEST precision picks a pixel exactly, as the gather does.
- descriptor_dim equals each descriptor's output width.
- fit_plane: with the reference's draws the inlier counts are equal.
- quat_to_rot: to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import interop
from slam3d_gx_torch.ops import lie as tlie
from slam3d_gx_torch.ops import plane_ransac as tplane
from slam3d_gx_torch.ops.features import common as tcommon
from slam3d_gx_torch.ops.features import fast as tfast
from slam3d_gx_torch.ops.features import orb as torb
from slam3d_gx_torch.ops.features import registry as treg
from slam3d_gx_torch.ops.features import star as tstar
from slam3d_gx_torch.ops.features import surf as tsurf
from slam3d_gx_torch.ops.features import surf_desc as tsurf_desc
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.ops import lie as jlie
from slam3d_gx_tpu.ops import plane_ransac as jplane
from slam3d_gx_tpu.ops.features import common as jcommon
from slam3d_gx_tpu.ops.features import fast as jfast
from slam3d_gx_tpu.ops.features import orb as jorb
from slam3d_gx_tpu.ops.features import registry as jreg
from slam3d_gx_tpu.ops.features import star as jstar
from slam3d_gx_tpu.ops.features import surf as jsurf
from slam3d_gx_tpu.ops.features import surf_desc as jsurf_desc
from slam3d_gx_tpu.testing import synthetic

K = 64


def render(h, w):
    s = w / 160.0
    intr = CameraIntrinsics(fx=130.0 * s, fy=130.0 * s, cx=w / 2, cy=h / 2, factor=5000.0)
    pose = synthetic.orbit_trajectory(4, radius=0.2, yaw_amp=0.1)[1]
    return synthetic.render_frame(synthetic.RoomScene(seed=3), pose, intr, h, w)


@pytest.fixture(scope="module")
def frame():
    return render(120, 160)


def t(a):
    return torch.as_tensor(np.array(a))


def kp_set(kps):
    """Valid keypoints as a set of (u, v, size)."""
    v = np.asarray(kps.valid).astype(bool)
    rows = np.c_[np.asarray(kps.uv)[v], np.asarray(kps.size)[v]]
    return {tuple(r) for r in rows.round(3).tolist()}


def test_fast_score_map_exact(frame):
    gray, _ = frame
    assert tfast._CIRCLE == jfast._CIRCLE
    for th in (10.0, 20.0):
        port = tfast.fast_score(t(gray), th).numpy()
        # the JAX detector's map, through its own keypoints: every valid
        # keypoint's response is its score
        ref = jfast.detect_fast(jnp.asarray(gray), threshold=th, max_kp=4096)
        v = np.asarray(ref.valid)
        uv = np.asarray(ref.uv)[v].astype(int)
        np.testing.assert_array_equal(port[uv[:, 1], uv[:, 0]], np.asarray(ref.response)[v])
        assert v.sum() > 50


def test_fast_score_map_equals_reference_formula():
    """The whole map, -inf included, against the JAX detector's formula
    run eagerly on an integer image (rolls, 16 cyclic AND windows)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 56)).astype(np.float32)
    x = jnp.asarray(img)
    taps = jnp.stack([jnp.roll(x, shift=(-dy, -dx), axis=(0, 1)) for dx, dy in jfast._CIRCLE])
    diff = taps - x[None]

    def has_arc(m):
        out = jnp.zeros_like(m[0])
        for s in range(16):
            run = m[s]
            for j in range(1, jfast._ARC):
                run = run & m[(s + j) % 16]
            out = out | run
        return out

    corner = has_arc(diff > 10.0) | has_arc(diff < -10.0)
    sb = jnp.sum(jnp.maximum(diff - 10.0, 0.0), axis=0)
    sd = jnp.sum(jnp.maximum(-diff - 10.0, 0.0), axis=0)
    ref = np.asarray(jnp.where(corner, jnp.maximum(sb, sd), -jnp.inf))
    np.testing.assert_array_equal(tfast.fast_score(t(img), 10.0).numpy(), ref)
    assert np.isfinite(ref).sum() > 20


@pytest.mark.parametrize("grid_fast", [False, True])
def test_fast_keypoint_sets(frame, grid_fast):
    gray, _ = frame
    if grid_fast:
        ref = jfast.detect_grid_fast(jnp.asarray(gray), max_kp=K)
        port = tfast.detect_grid_fast(t(gray), max_kp=K)
    else:
        ref = jfast.detect_fast(jnp.asarray(gray), max_kp=K)
        port = tfast.detect_fast(t(gray), max_kp=K)
    assert kp_set(port) == kp_set(ref) and len(kp_set(ref)) > K // 4


def test_grid_fast_budget_per_cell():
    """Many corners a cell, with equal scores: given the same FAST
    keypoints, the port keeps exactly those the JAX detector keeps, and
    no cell more than max_kp / grid^2."""
    rng = np.random.default_rng(5)
    img = jnp.asarray((rng.random((120, 160)) > 0.5).astype(np.float32) * 200.0)
    kps = jfast.detect_fast(img, max_kp=K)
    ref = jfast.detect_grid_fast(img, max_kp=K)
    port = tfast.grid_budget(tcommon.Keypoints(*(t(a) for a in kps)), 120, 160, K)
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    uv = port.uv.numpy()[port.valid.numpy()]
    cell = (uv[:, 1] * 4 // 120).astype(int) * 4 + (uv[:, 0] * 4 // 160).astype(int)
    counts = np.bincount(cell, minlength=16)
    assert counts.max() <= K // 16 and counts.sum() > K // 2
    assert len(np.unique(np.asarray(kps.response)[np.asarray(kps.valid)])) < K // 2  # ties


def test_surf_and_star_response_stacks_exact_integral(frame):
    gray, _ = frame
    H, W = gray.shape
    assert H * W * 255 < 2**24
    pad = jsurf._SIZES[-1]
    iip_j = jsurf._pad_integral(jsurf._integral(jnp.asarray(gray)), pad)
    iip_t = tsurf._pad_integral(tsurf._integral(t(gray)), pad)
    np.testing.assert_array_equal(iip_t.numpy(), np.asarray(iip_j))
    for s in jsurf._SIZES:
        ref = np.asarray(jsurf._hessian_response(iip_j, s, pad, H, W))
        port = tsurf._hessian_response(iip_t, s, pad, H, W).numpy()
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["SURF", "STAR"])
def test_surf_star_keypoint_sets_160x120(frame, name):
    gray, _ = frame
    jdet = {"SURF": jsurf.detect_surf, "STAR": jstar.detect_star}[name]
    tdet = {"SURF": tsurf.detect_surf, "STAR": tstar.detect_star}[name]
    ref = jdet(jnp.asarray(gray), max_kp=K)
    port = tdet(t(gray), max_kp=K)
    assert kp_set(port) == kp_set(ref) and len(kp_set(ref)) > K // 4
    order_r = np.argsort(-np.asarray(ref.response))
    order_p = np.argsort(-port.response.numpy())
    np.testing.assert_allclose(port.response.numpy()[order_p], np.asarray(ref.response)[order_r],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["SURF", "STAR"])
def test_surf_star_keypoint_overlap_320x240(name):
    gray, _ = render(240, 320)
    assert gray.size * 255 > 2**24
    jdet = {"SURF": jsurf.detect_surf, "STAR": jstar.detect_star}[name]
    tdet = {"SURF": tsurf.detect_surf, "STAR": tstar.detect_star}[name]
    ref, port = kp_set(jdet(jnp.asarray(gray), max_kp=256)), kp_set(tdet(t(gray), max_kp=256))
    assert len(ref) > 64
    assert len(ref & port) >= 0.95 * max(len(ref), len(port))


def test_surf_descriptor_on_the_same_keypoints(frame):
    gray, _ = frame
    kps = jsurf.detect_surf(jnp.asarray(gray), max_kp=K)
    ref = np.asarray(jsurf_desc.surf_descriptors(jnp.asarray(gray), kps))
    port = tsurf_desc.surf_descriptors(t(gray), tcommon.Keypoints(*(t(a) for a in kps))).numpy()
    v = np.asarray(kps.valid)
    assert port.shape == ref.shape == (K, 64) and v.sum() > K // 4
    np.testing.assert_allclose(port, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(port[v], axis=1), 1.0, atol=1e-5)


def test_orb_pattern_and_bits(frame):
    gray, _ = frame
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    kps = jfast.detect_grid_fast(jnp.asarray(gray), max_kp=K)
    ref = np.asarray(jorb.orb_descriptors(jnp.asarray(gray), kps))
    port = torb.orb_descriptors(t(gray), tcommon.Keypoints(*(t(a) for a in kps))).numpy()
    # each package's orientation bin, from its own blurred patches
    x = jnp.asarray(gray, jnp.float32)
    pj = jorb._extract_patches(jcommon.gaussian_blur(x, 2.0), kps.uv) * jorb._CIRC[None]
    angle = jnp.arctan2(jnp.sum(pj * jorb._OFF_Y[None], axis=(1, 2)),
                        jnp.sum(pj * jorb._OFF_X[None], axis=(1, 2)))
    bin_j = np.asarray(jnp.round(jnp.mod(angle, 2 * jnp.pi) / (2 * jnp.pi) * jorb.N_BINS)
                       .astype(jnp.int32) % jorb.N_BINS)
    bin_t = torb.orientation_bins(torb._extract_patches(
        tcommon.gaussian_blur(t(gray).float(), 2.0), t(kps.uv))).numpy()
    v = np.asarray(kps.valid)
    assert v.sum() > K // 4 and len(np.unique(bin_j[v])) > 5
    same_bin = bin_t == bin_j
    assert same_bin[v].mean() >= 0.99
    np.testing.assert_array_equal(port[same_bin], ref[same_bin])
    assert set(np.unique(port)) <= {0.0, 1.0} and (port[~v] == 0).all()
    assert 0.2 < port[v].mean() < 0.8


def test_orb_taps_equal_the_one_hot_matrices():
    onehots = np.asarray(jorb._ONEHOTS)  # (bins, P*P, 512)
    table = torb._tap_table()
    np.testing.assert_array_equal(np.argmax(onehots, axis=1), table)
    assert (onehots.sum(axis=1) == 1).all()


@pytest.mark.parametrize("name", ["SIFT", "SURF_SIFT", "SURF-SIFT", "SURF", "ORB", "BRIEF"])
def test_descriptor_dim_matches_output(frame, name):
    gray, _ = frame
    kps = tfast.detect_fast(t(gray), max_kp=16)
    d = treg.create_descriptor(name)(t(gray), kps)
    assert d.shape == (16, treg.descriptor_dim(name)) == (16, jreg.descriptor_dim(name))
    assert treg.match_floor(name) == jreg.match_floor(name)


@pytest.mark.parametrize("detector", ["SIFT", "SURF", "STAR", "GFTT", "HARRIS", "FAST",
                                      "GridFAST", "ORB"])
def test_every_detector_name_runs(frame, detector):
    gray, _ = frame
    kps, desc = treg.detect_and_describe(detector, "ORB", K)(t(gray))
    assert kps.uv.shape == (K, 2) and desc.shape == (K, 256)
    assert kps.valid.sum() > 0


def test_fit_plane_batched_given_reference_draws():
    rng = np.random.default_rng(3)
    B, N, hyp = 12, 49, 64
    pts = rng.normal(0, 0.05, (B, N, 3)).astype(np.float32)
    pts[:, :, 2] = 1.0 + 0.02 * pts[:, :, 0]  # a plane, then outliers
    pts[:, ::5, 2] += rng.uniform(0.05, 0.2, (B, len(range(0, N, 5)))).astype(np.float32)
    mask = rng.random((B, N)) > 0.1
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    counts_j = jax.vmap(lambda p, m, k: jplane.fit_plane(p, m, k, dist_thresh=0.01)[2])(
        jnp.asarray(pts), jnp.asarray(mask), keys)
    gumbel = np.stack([np.stack([np.asarray(jax.random.gumbel(kk, (hyp, 3, N), jnp.float32))
                                 for kk in jax.random.split(k, 1)]) for k in keys])
    coeff, inl, counts_t = tplane.fit_plane(t(pts), t(mask), interop.plane_sampler(gumbel, "cpu"),
                                            dist_thresh=0.01, hypotheses=hyp)
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    assert coeff.shape == (B, 4) and inl.shape == (B, N)
    assert (counts_t.numpy() > 30).all()


def test_quat_to_rot_matches_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q[0] = 0.0  # the zero quaternion: s = 2 / 1
    np.testing.assert_allclose(tlie.quat_to_rot(t(q)).numpy(),
                               np.asarray(jlie.quat_to_rot(jnp.asarray(q))), atol=1e-6)
    R = tlie.quat_to_rot(t(q[1:] / np.linalg.norm(q[1:], axis=1, keepdims=True)))
    np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(),
                               np.broadcast_to(np.eye(3), (31, 3, 3)), atol=1e-5)
