"""Parity of the port's geometry ops and plane RANSAC with the JAX package.

The same numpy inputs, made from a seed, go through both packages.
Tolerances: fp32 elementwise ops agree to a few ulps (atol 1e-5 on
O(1) values); the plane RANSAC, handed the reference's own Gumbel draws,
must pick the same triplets, so its masks match exactly and its
coefficients (a 3x3 eigh on each side) within 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import interop
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.frontend import pipeline as tpipe
from slam3d_gx_torch.ops import lie as tlie
from slam3d_gx_torch.ops import plane_ransac as tplane
from slam3d_gx_torch.ops import pointcloud as tpc
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.frontend import pipeline as jpipe
from slam3d_gx_tpu.ops import lie as jlie
from slam3d_gx_tpu.ops import plane_ransac as jplane
from slam3d_gx_tpu.ops import pointcloud as jpc

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
TINTR = TorchIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
CAM = (260.0, 260.0, 160.0, 120.0, 5000.0)


def t(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture
def rot_vecs():
    rng = np.random.default_rng(7)
    axes = rng.normal(size=(64, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    # small, ordinary and near-pi angles, plus exact zero
    angles = np.concatenate([rng.uniform(0, 1e-4, 8), rng.uniform(0.1, 3.0, 48),
                             rng.uniform(3.1, 3.14, 7), [0.0]])
    return (axes * angles[:, None]).astype(np.float32)


def test_rodrigues_and_hat(rot_vecs):
    close(tlie.hat(t(rot_vecs)), jlie.hat(jnp.asarray(rot_vecs)))
    close(tlie.rodrigues(t(rot_vecs)), jlie.rodrigues(jnp.asarray(rot_vecs)))


def test_inv_rodrigues_and_quat(rot_vecs):
    R = np.asarray(jlie.rodrigues(jnp.asarray(rot_vecs)))
    close(tlie.rot_to_quat(t(R)), jlie.rot_to_quat(jnp.asarray(R)))
    # near theta = pi the axis sign is ill-conditioned in fp32: compare
    # the rotations the vectors stand for
    rv_port = tlie.inv_rodrigues(t(R))
    close(tlie.rodrigues(rv_port), R, atol=1e-5)
    ordinary = np.linalg.norm(rot_vecs, axis=1) < 3.0
    close(rv_port.numpy()[ordinary],
          np.asarray(jlie.inv_rodrigues(jnp.asarray(R)))[ordinary])


def test_make_inv_T_and_se3(rot_vecs):
    rng = np.random.default_rng(8)
    xi = np.concatenate([rng.normal(size=(64, 3)) * 0.5, rot_vecs * 0.5], 1).astype(np.float32)
    Tj = jlie.se3_exp(jnp.asarray(xi))
    Tt = tlie.se3_exp(t(xi))
    close(Tt, Tj)
    close(tlie.inv_T(Tt), jlie.inv_T(Tj))
    close(tlie.make_T(Tt[:, :3, :3], Tt[:, :3, 3]), jlie.make_T(Tj[:, :3, :3], Tj[:, :3, 3]))
    # se3_log solves a 3x3 system: 1e-4 on O(1) tangents
    close(tlie.se3_log(Tt), jlie.se3_log(Tj), atol=1e-4, rtol=1e-4)


def test_pointcloud_ops():
    rng = np.random.default_rng(9)
    depth = rng.integers(0, 20000, (24, 32)).astype(np.uint16)
    depth[::5, ::3] = 0
    xyz_j, valid_j = jpc.backproject(jnp.asarray(depth), *CAM)
    xyz_t, valid_t = tpc.backproject(t(depth.astype(np.int32)), *CAM)
    close(xyz_t, xyz_j)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))

    pts = (rng.normal(size=(200, 3)) + [0, 0, 2]).astype(np.float32)
    close(tpc.project(t(pts), 260.0, 260.0, 160.0, 120.0),
          jpc.project(jnp.asarray(pts), 260.0, 260.0, 160.0, 120.0), atol=1e-3)
    mask = rng.random(200) > 0.2
    np.testing.assert_array_equal(
        tpc.passthrough_z(t(pts), t(mask), 0.0, 2.5).numpy(),
        np.asarray(jpc.passthrough_z(jnp.asarray(pts), jnp.asarray(mask), 0.0, 2.5)))
    T = np.asarray(jlie.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 0.05, 0.1, -0.02], jnp.float32)))
    close(tpc.transform_points(t(T), t(pts)), jpc.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    ref_s = jpc.estimate_depth_scale(xyz_j.reshape(-1, 3), depth, *CAM,
                                     stride=1, min_samples=10)
    port_s = tpc.estimate_depth_scale(xyz_t.reshape(-1, 3).numpy(), depth,
                                      *CAM, stride=1, min_samples=10)
    assert port_s == pytest.approx(ref_s, rel=1e-6)


def test_compute_kp3d_plane():
    rng = np.random.default_rng(10)
    depth = rng.integers(0, 20000, (24, 32)).astype(np.uint16)
    depth[rng.random((24, 32)) < 0.3] = 0  # zero depth -> plane-ray fallback
    uv = rng.uniform(-2, 34, (3, 16, 2)).astype(np.float32)
    coeff = np.array([[0.1, 0.2, -0.97, 2.5], [0.0, 0.0, 1.0, 0.0],
                      [0.6, 0.0, -0.8, 1.2]], np.float32)
    ref = [np.asarray(jpipe.compute_kp3d_plane(jnp.asarray(depth), jnp.asarray(uv[p]),
                                               jnp.asarray(coeff[p]), INTR)[0])
           for p in range(3)]
    port, ok = tpipe.compute_kp3d_plane(t(depth.astype(np.int32)), t(uv), t(coeff), TINTR)
    assert ok.all()
    close(port, np.stack(ref), atol=1e-4)


def _room_cloud(rng, n):
    """Points on a floor, a wall and a side wall, plus clutter."""
    k = n // 4
    floor = np.c_[rng.uniform(-2, 2, k), np.full(k, 1.2), rng.uniform(1, 4, k)]
    wall = np.c_[rng.uniform(-2, 2, k), rng.uniform(-1, 1.2, k), np.full(k, 4.0)]
    side = np.c_[np.full(k, -1.5), rng.uniform(-1, 1.2, k), rng.uniform(1, 4, k)]
    clutter = rng.uniform([-2, -1, 1], [2, 1.2, 4], (n - 3 * k, 3))
    xyz = np.concatenate([floor, wall, side, clutter]) + rng.normal(0, 0.01, (n, 3))
    return xyz.astype(np.float32)


@pytest.mark.parametrize("hypotheses", [8, 32])
def test_extract_planes_given_reference_draws(hypotheses):
    rng = np.random.default_rng(11)
    n, planes = 2048, 3
    xyz = _room_cloud(rng, n)
    mask = rng.random(n) > 0.1
    key = jax.random.PRNGKey(5)
    coeffs_j, masks_j, valid_j, rem_j = jplane.extract_planes(
        jnp.asarray(xyz), jnp.asarray(mask), key, max_planes=planes,
        hypotheses=hypotheses)
    keys = jax.random.split(key, planes)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (hypotheses, 3, n), jnp.float32))
                       for k in keys])
    coeffs_t, masks_t, valid_t, rem_t = tplane.extract_planes(
        t(xyz), t(mask), interop.plane_sampler(gumbel, "cpu"), max_planes=planes,
        hypotheses=hypotheses)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(masks_t.numpy(), np.asarray(masks_j))
    np.testing.assert_array_equal(rem_t.numpy(), np.asarray(rem_j))
    close(coeffs_t, coeffs_j, atol=1e-4, rtol=0)
    assert valid_t.sum() >= 2


def test_uniform_sampler_draws_only_remaining_points():
    gen = torch.Generator().manual_seed(0)
    remaining = torch.zeros(100, dtype=torch.bool)
    remaining[[3, 17, 18, 60, 99]] = True
    idx = tplane.UniformSampler(gen)(0, remaining, 256)
    assert idx.shape == (256, 3)
    assert remaining[idx].all()
    assert set(idx.unique().tolist()) == {3, 17, 18, 60, 99}
