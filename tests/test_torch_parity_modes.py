"""The extractor's parity modes in the port against the JAX package, on
the CPU: `voxel_downsample` (config key `voxel_downsample_clouds`),
`splat_plane_image` (`plane_image_mode: splat`) and the per-plane pass
(`detect_scope: plane`).

Tolerances and why:
- voxel_downsample: the voxel ids are integers, so the mask and the
  order of the voxels are exact; each centroid is a float32 sum in the
  same (sorted, stable) order divided by the count, 1e-6;
- splat_plane_image: integer pixels and radii, exact;
- the plane-scope extractor (GFTT + SIFT, 160x120, 64 keypoints, 32
  hypotheses, the JAX one jitted, the same Gumbel draws): as
  tests/test_torch_imageonly.py's plane extractor, valid keypoints as
  sets of rows (top-k orders equal responses differently), pixels exact,
  kp3d 1e-3, plane coefficients 1e-4, descriptors +-1.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam3d_gx_torch import interop
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.config import ParameterReader as TorchParams
from slam3d_gx_torch.frontend import GraphicEnd as TGraphicEnd
from slam3d_gx_torch.frontend import pipeline as tpipe
from slam3d_gx_torch.ops import imageproc as timg
from slam3d_gx_torch.ops import pointcloud as tpc
from slam3d_gx_tpu.config import CameraIntrinsics, ParameterReader
from slam3d_gx_tpu.frontend import GraphicEnd
from slam3d_gx_tpu.frontend import pipeline as jpipe
from slam3d_gx_tpu.ops import imageproc as jimg
from slam3d_gx_tpu.ops import pointcloud as jpc
from slam3d_gx_tpu.testing import synthetic

H, W, K = 120, 160, 64
INTR = CameraIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)
TINTR = TorchIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                rng.uniform(0.3, 6, n)].astype(np.float32)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.8
    return xyz, rgb, mask


@pytest.mark.parametrize("leaf,capacity", [(0.05, None), (0.3, 2000), (0.02, 500)],
                         ids=["fine", "coarse", "above-capacity"])
def test_voxel_downsample_matches_jax(leaf, capacity):
    xyz, rgb, mask = _cloud(int(leaf * 1000))
    ref = jpc.voxel_downsample(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(mask), leaf,
                               capacity=capacity)
    got = tpc.voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(rgb),
                               torch.from_numpy(mask), leaf, capacity=capacity)
    ref_x, ref_c, ref_m = (np.asarray(a) for a in ref)
    got_x, got_c, got_m = (a.numpy() for a in got)
    assert got_m.shape == ref_m.shape == ((capacity or len(xyz)),)
    np.testing.assert_array_equal(got_m, ref_m)
    np.testing.assert_allclose(got_x, ref_x, atol=1e-6)
    np.testing.assert_allclose(got_c, ref_c, atol=1e-4, rtol=1e-6)  # 0-255 colors
    assert 0 < got_m.sum() and got_m[:got_m.sum()].all()  # packed to the front
    if capacity == 500:
        assert got_m.all()  # more voxels than rows: the first 500 by voxel id


def test_voxel_downsample_of_nothing():
    xyz, rgb, _ = _cloud(1, 50)
    x, c, m = tpc.voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(rgb),
                                   torch.zeros(50, dtype=torch.bool), 0.1)
    assert not m.any() and not x.any() and not c.any()


def _splat_points(seed):
    """Points on a plane, some projecting outside the image within the
    splat's reach (R_MAX = 10 px) and some far outside it."""
    rng = np.random.default_rng(seed)
    n = 400
    u = rng.uniform(-25, W + 25, n)
    v = rng.uniform(-25, H + 25, n)
    z = rng.uniform(0.5, 11.0, n)
    xyz = np.c_[(u - INTR.cx) * z / INTR.fx, (v - INTR.cy) * z / INTR.fy, z].astype(np.float32)
    xyz[:5, 2] = -1.0  # behind the camera: never painted
    mask = rng.random(n) < 0.7
    gray = rng.integers(0, 256, (H, W)).astype(np.uint8)
    return xyz, mask, gray, u, v


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_plane_image_matches_jax(seed):
    xyz, mask, gray, u, v = _splat_points(seed)
    outside = mask & ((u < 0) | (u >= W) | (v < 0) | (v >= H))
    assert outside.sum() > 20  # the overhang rule is exercised
    ref_img, ref_m = jimg.splat_plane_image(jnp.asarray(xyz), jnp.asarray(mask),
                                            jnp.asarray(gray), INTR.fx, INTR.fy, INTR.cx,
                                            INTR.cy, height=H, width=W)
    img, m = timg.splat_plane_image(torch.from_numpy(xyz), torch.from_numpy(mask),
                                    torch.from_numpy(gray), TINTR.fx, TINTR.fy, TINTR.cx,
                                    TINTR.cy, height=H, width=W)
    assert img.dtype == torch.uint8 and m.dtype == torch.bool
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref_img))
    assert 0 < int(m.sum()) < H * W


def test_splat_plane_image_batches_planes():
    """A (P,N) mask splats each plane as the JAX package's vmap does."""
    xyz, mask, gray, _, _ = _splat_points(2)
    rng = np.random.default_rng(5)
    masks = np.stack([mask & (rng.random(len(mask)) < 0.5) for _ in range(3)])
    masks[2] = False  # an empty plane slot
    img, m = timg.splat_plane_image(torch.from_numpy(xyz), torch.from_numpy(masks),
                                    torch.from_numpy(gray), TINTR.fx, TINTR.fy, TINTR.cx,
                                    TINTR.cy, height=H, width=W)
    assert img.shape == m.shape == (3, H, W) and not m[2].any()
    for p in range(3):
        ref_img, ref_m = jimg.splat_plane_image(jnp.asarray(xyz), jnp.asarray(masks[p]),
                                                jnp.asarray(gray), INTR.fx, INTR.fy, INTR.cx,
                                                INTR.cy, height=H, width=W)
        np.testing.assert_array_equal(m[p].numpy(), np.asarray(ref_m))
        np.testing.assert_array_equal(img[p].numpy(), np.asarray(ref_img))


def rows_of(feats, p):
    """Valid keypoints of plane p as rows (uv, kp3d, desc), sorted by pixel."""
    f = {n: np.asarray(getattr(feats, n)) for n in feats._fields}
    v = f["kp_valid"][p].astype(bool)
    rows = np.c_[f["uv"][p][v], f["kp3d"][p][v], f["desc"][p][v]]
    return rows[np.lexsort(rows[:, :2].T[::-1])]


@pytest.mark.parametrize("scope,mode", [("plane", "membership"), ("plane", "splat"),
                                        ("frame", "splat")])
def test_plane_extractor_modes_match_jax(scope, mode):
    scene = synthetic.RoomScene(seed=3)
    pose = synthetic.orbit_trajectory(4, radius=0.2, yaw_amp=0.1)[1]
    gray, depth = synthetic.render_frame(scene, pose, INTR, H, W)
    xyz_img, valid_img = jpc.backproject(jnp.asarray(depth), INTR.fx, INTR.fy, INTR.cx,
                                         INTR.cy, INTR.factor)
    cloud = np.asarray(xyz_img).reshape(-1, 3)
    mask = np.asarray(valid_img).reshape(-1)
    hyp, planes = 32, 3
    key = jax.random.PRNGKey(2)
    # a low plane_percent keeps all three slots in play on this frame
    kw = dict(max_kp=K, hypotheses=hyp, max_planes=planes, detect_scope=scope, percent=0.02,
              plane_image_mode=mode)
    ref = jpipe.build_plane_extractor("GFTT", "SIFT", INTR, **kw)(
        jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(cloud), jnp.asarray(mask), key)
    n = min(-(-cloud.shape[0] // max(1, cloud.shape[0] // tpipe.PLANE_POINTS)),
            tpipe.PLANE_POINTS)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (hyp, 3, n), jnp.float32))
                       for k in jax.random.split(key, planes)])
    port = tpipe.build_plane_extractor("GFTT", "SIFT", TINTR, **kw)(
        torch.from_numpy(gray.copy()), torch.from_numpy(depth.astype(np.int32)),
        torch.from_numpy(cloud), torch.from_numpy(mask), interop.plane_sampler(gumbel, "cpu"))
    assert port.uv.shape == (planes, K, 2) and port.desc.shape == (planes, K, 128)
    np.testing.assert_array_equal(port.plane_valid.numpy(), np.asarray(ref.plane_valid))
    np.testing.assert_allclose(port.coeffs.numpy(), np.asarray(ref.coeffs), atol=1e-4)
    assert int(port.plane_valid.sum()) >= 2 and int(port.kp_valid.sum()) > 0
    for p in range(planes):
        rr, pp = rows_of(ref, p), rows_of(port, p)
        assert len(rr) == len(pp)
        if len(rr):
            np.testing.assert_array_equal(pp[:, :2], rr[:, :2])
            np.testing.assert_allclose(pp[:, 2:5], rr[:, 2:5], atol=1e-3)
            assert np.abs(pp[:, 5:] - rr[:, 5:]).max() <= 1.0


def test_readimage_voxel_grid_matches_jax(tmp_path):
    """voxel_downsample_clouds: 1 in the frontend: the cloud readimage
    hands the extractor is the JAX frontend's, mask exact and xyz 1e-6."""
    traj = synthetic.orbit_trajectory(3, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(str(tmp_path), synthetic.RoomScene(seed=3), traj, INTR,
                            height=H, width=W, write_pcd=True)
    over = dict(data_source=str(tmp_path), camera_fx=INTR.fx, camera_fy=INTR.fy,
                camera_cx=INTR.cx, camera_cy=INTR.cy, camera_factor=INTR.factor,
                voxel_downsample_clouds=1, grid_leaf=0.05)
    ref = GraphicEnd(ParameterReader(None, overrides=over), data_dir=str(tmp_path / "j"))
    port = TGraphicEnd(TorchParams(None, overrides=over), data_dir=str(tmp_path / "t"),
                       device="cpu")
    for ge in (ref, port):
        ge.index = 2
        ge.readimage()
    assert tuple(port.curr_cloud.shape) == (min(H * W, 4 * tpipe.PLANE_POINTS), 3)
    np.testing.assert_array_equal(port.curr_cloud_mask.numpy(), np.asarray(ref.curr_cloud_mask))
    np.testing.assert_allclose(port.curr_cloud.numpy(), np.asarray(ref.curr_cloud), atol=1e-6)
    assert 100 < int(port.curr_cloud_mask.sum()) < 4 * tpipe.PLANE_POINTS
    assert not os.path.exists(tmp_path / "t")  # reading writes nothing
