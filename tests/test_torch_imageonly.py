"""The image-only path of the port against the JAX package, on the CPU.

Inputs are synthetic frames (seeded) at 160x120 with 64 keypoints.
Tolerances and why:
- `compute_kp3d_drop`: fp32 arithmetic in the same order, 1e-6;
- extractors (image and plane, GFTT + SIFT descriptor, the JAX ones
  jitted): valid keypoints compared as sets of rows, because top-k
  orders equal responses differently; pixel positions exact (GFTT
  keypoints are integer pixels), kp3d 1e-5, plane coefficients 1e-4,
  descriptors +-1 (integers, each entry may round the other way by one
  fp32 ulp, tests/test_torch_features.py);
- `build_multipnp_image` against JAX, jitted under `jitted_reference()`
  (tests/test_torch_jaxref.py), with the reference's draw `jax.random.uniform(key, (H,3))`: `ok` and
  the inlier count exact, T and norm within 1e-4 (fp32 Gauss-Newton on
  each side);
- GraphicEnd2 alone over a short orbit (320x240, 256 keypoints, 128
  hypotheses): ATE below 0.05 m, the bound of the JAX package's own
  image-only test (tests/test_e2e.py:67), and the reference's file set.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from slam3d_gx_torch import interop
from slam3d_gx_torch.backend import SLAMEnd
from slam3d_gx_torch.cli import run_slam_imageonly
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.config import ParameterReader
from slam3d_gx_torch.frontend import GraphicEnd2
from slam3d_gx_torch.frontend import pipeline as tpipe
from slam3d_gx_torch.frontend.state import result_to_host
from slam3d_gx_torch.io import g2o_io, tum
from slam3d_gx_torch.testing import synthetic as tsynthetic
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.frontend import pipeline as jpipe
from slam3d_gx_tpu.ops import pointcloud as jpc
from slam3d_gx_tpu.testing import synthetic
from test_torch_jaxref import jitted  # noqa: F401  (a fixture)

H, W, K = 120, 160, 64
INTR = CameraIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)
TINTR = TorchIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def frame():
    scene = synthetic.RoomScene(seed=3)
    pose = synthetic.orbit_trajectory(4, radius=0.2, yaw_amp=0.1)[1]
    gray, depth = synthetic.render_frame(scene, pose, INTR, H, W)
    depth = depth.copy()
    depth[:, : W // 4] = 0  # a band without depth: its keypoints are dropped
    return gray, depth


def test_compute_kp3d_drop_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 20000, (H, W)).astype(np.int32)
    depth[rng.random((H, W)) < 0.3] = 0
    uv = np.c_[rng.uniform(-2, W + 2, 200), rng.uniform(-2, H + 2, 200)].astype(np.float32)
    ref3d, ref_ok = jpipe.compute_kp3d_drop(jnp.asarray(depth), jnp.asarray(uv), INTR)
    got3d, got_ok = tpipe.compute_kp3d_drop(t(depth), t(uv), TINTR)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(got3d.numpy(), np.asarray(ref3d), atol=1e-6)
    assert 0 < int(got_ok.sum()) < 200


def rows_of(feats, p=0):
    """Valid keypoints of plane p as rows (uv, kp3d, desc), sorted by pixel."""
    f = {n: np.asarray(getattr(feats, n)) for n in feats._fields}
    v = f["kp_valid"][p].astype(bool)
    rows = np.c_[f["uv"][p][v], f["kp3d"][p][v], f["desc"][p][v]]
    return rows[np.lexsort(rows[:, :2].T[::-1])]


def test_image_extractor_matches_jax(frame):
    gray, depth = frame
    ref = jpipe.build_image_extractor("GFTT", "SIFT", INTR, max_kp=K)(
        jnp.asarray(gray), jnp.asarray(depth))
    port = tpipe.build_image_extractor("GFTT", "SIFT", TINTR, max_kp=K)(
        t(gray), t(depth.astype(np.int32)))
    assert port.uv.shape == (1, K, 2) and port.desc.shape == (1, K, 128)
    assert port.coeffs.shape == (1, 4) and not port.coeffs.any()
    assert bool(port.plane_valid.all())
    r, p = rows_of(ref), rows_of(port)
    assert len(r) == len(p) and K // 4 < len(r) < K  # some were dropped for depth
    np.testing.assert_array_equal(p[:, :2], r[:, :2])
    np.testing.assert_allclose(p[:, 2:5], r[:, 2:5], atol=1e-5)
    assert np.abs(p[:, 5:] - r[:, 5:]).max() <= 1.0
    assert (p[:, 2:5][:, 2] > 0).all()  # every valid keypoint has depth
    # the dropped keypoints lie in the band without depth
    dropped = ~port.kp_valid[0].numpy() & (port.uv[0, :, 0].numpy() < W // 4)
    assert dropped.any()


def test_plane_extractor_with_gftt_matches_jax(frame):
    gray, depth = frame
    xyz_img, valid_img = jpc.backproject(jnp.asarray(depth), INTR.fx, INTR.fy, INTR.cx,
                                         INTR.cy, INTR.factor)
    cloud = np.asarray(xyz_img).reshape(-1, 3)
    mask = np.asarray(valid_img).reshape(-1)
    hyp, planes = 32, 3
    key = jax.random.PRNGKey(2)
    ref = jpipe.build_plane_extractor("GFTT", "SIFT", INTR, max_kp=K, hypotheses=hyp,
                                      max_planes=planes)(
        jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(cloud), jnp.asarray(mask), key)
    n = min(cloud.shape[0] // max(1, cloud.shape[0] // tpipe.PLANE_POINTS),
            tpipe.PLANE_POINTS)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (hyp, 3, n), jnp.float32))
                       for k in jax.random.split(key, planes)])
    port = tpipe.build_plane_extractor("GFTT", "SIFT", TINTR, max_kp=K, hypotheses=hyp,
                                       max_planes=planes)(
        t(gray), t(depth.astype(np.int32)), t(cloud), t(mask),
        interop.plane_sampler(gumbel, "cpu"))
    np.testing.assert_array_equal(port.plane_valid.numpy(), np.asarray(ref.plane_valid))
    np.testing.assert_allclose(port.coeffs.numpy(), np.asarray(ref.coeffs), atol=1e-4)
    assert int(port.plane_valid.sum()) >= 1 and int(port.kp_valid.sum()) > 0
    for p in range(planes):
        rr, pp = rows_of(ref, p), rows_of(port, p)
        assert len(rr) == len(pp)
        if len(rr):
            np.testing.assert_array_equal(pp[:, :2], rr[:, :2])
            np.testing.assert_allclose(pp[:, 2:5], rr[:, 2:5], atol=1e-3)
            assert np.abs(pp[:, 5:] - rr[:, 5:]).max() <= 1.0


def test_multipnp_image_matches_jax(jitted):
    big = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
    tbig = TorchIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
    hyp = 32
    fa, fb = __graft_entry__._plane_frame_pair(big, np.random.default_rng(0), p=1, k=32)
    # integer descriptors, as SIFT's are: exact matches have distance 0
    fa = fa._replace(desc=jnp.round(jnp.abs(fa.desc)))
    fb = fb._replace(desc=jnp.round(jnp.abs(fb.desc)))
    key = jax.random.PRNGKey(3)
    fn = jpipe.build_multipnp_image(big, hypotheses=hyp)
    ref = fn(fa, fb, key, 12)
    ref_T, ref_norm = np.asarray(ref.T), float(ref.norm)
    ref_inl, ref_ok = int(ref.inliers), bool(ref.ok)
    assert ref_ok
    u = interop.pnp_uniforms([np.asarray(jax.random.uniform(key, (hyp, 3)))], "cpu")[0]
    pa = interop.features_from_numpy([np.asarray(a) for a in fa], "cpu")
    pb = interop.features_from_numpy([np.asarray(a) for a in fb], "cpu")
    port_fn = tpipe.build_multipnp_image(tbig)
    T, norm, inl, ok = result_to_host(port_fn(pa, pb, u, 12))
    assert ok and inl == ref_inl
    assert norm == pytest.approx(ref_norm, abs=1e-4)
    np.testing.assert_allclose(T, ref_T, atol=1e-4)
    # the gate above the inlier count rejects with the identity and norm 0
    T, norm, inl, ok = result_to_host(port_fn(pa, pb, u, ref_inl + 1))
    assert not ok and norm == 0.0 and inl == ref_inl
    np.testing.assert_array_equal(T, np.eye(4))
    # no valid keypoint in the target: no match, no pose
    empty = pb._replace(kp_valid=torch.zeros_like(pb.kp_valid))
    assert not result_to_host(port_fn(pa, empty, u, 12))[3]


RUN_INTR = TorchIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N_FRAMES = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("room"))
    traj = tsynthetic.orbit_trajectory(12, radius=0.2, yaw_amp=0.1)[:N_FRAMES]
    tsynthetic.write_dataset(root, tsynthetic.RoomScene(seed=3), traj, RUN_INTR,
                             write_pcd=False)
    return root, traj


def overrides(root):
    return dict(data_source=root, detector_name="GFTT", descriptor_name="SIFT",
                camera_fx=RUN_INTR.fx, camera_fy=RUN_INTR.fy, camera_cx=RUN_INTR.cx,
                camera_cy=RUN_INTR.cy, camera_factor=RUN_INTR.factor, max_keypoints=256,
                ransac_hypotheses=128, max_pos_change=0.05, end_index=100, grid_leaf=0.05)


@pytest.fixture(scope="module")
def imageonly_run(dataset, tmp_path_factory):
    root, traj = dataset
    datadir = str(tmp_path_factory.mktemp("data_img"))
    ge = GraphicEnd2(ParameterReader(None, overrides=overrides(root)), data_dir=datadir,
                     device="cpu")
    slam = SLAMEnd(device="cpu")
    ge.init(slam)
    slam.init(ge)
    for _ in range(N_FRAMES - 1):
        assert ge.run() == 0
    slam.globalOptimizer.save(os.path.join(datadir, "final.g2o"))
    ge.save_final_result()
    return ge, datadir, traj


def test_graphic_end2_tracks_the_orbit(imageonly_run):
    ge, _, traj = imageonly_run
    assert ge.image_only and len(ge.keyframes) >= 2
    assert ge.extractions == N_FRAMES
    feats = ge.keyframes[-1].features
    assert feats.uv.shape[0] == 1 and feats.desc.device.type == "cpu"
    est = [ge.opt.vertex_estimate(kf.id) for kf in ge.keyframes]
    gt = [traj[kf.frame_index - 1] for kf in ge.keyframes]
    ate = tsynthetic.ate_rmse(gt, est)
    assert ate < 0.05, f"ATE {ate}"


def test_graphic_end2_writes_the_reference_files(imageonly_run):
    ge, datadir, _ = imageonly_run
    log = open(os.path.join(datadir, "error_of_transform.log")).read().split()
    assert len(log) == N_FRAMES - 1  # one row per run(), lost frames as 9999
    kf = tum.read_keyframes(os.path.join(datadir, "keyframe.txt"))
    assert [k for k, _ in kf] == list(range(len(ge.keyframes)))
    pre = g2o_io.load_g2o(os.path.join(datadir, "final.g2o"))
    post = g2o_io.load_g2o(os.path.join(datadir, "final_after.g2o"))
    assert set(pre.vertices) == set(post.vertices) and pre.vertices[0].fixed
    assert len(pre.edges) >= len(ge.keyframes) - 1


def test_cli_run_slam_imageonly_returns_0(dataset, tmp_path, monkeypatch):
    root, _ = dataset
    with open(tmp_path / "parameters.yaml", "w") as f:
        for k, v in overrides(root).items():
            f.write(f"{k}: {v}\n")
    monkeypatch.chdir(tmp_path)
    stats = {}
    assert run_slam_imageonly.main(argv=["2"], device="cpu", stats=stats) == 0
    for name in ("final.g2o", "final_after.g2o", "keyframe.txt", "error_of_transform.log"):
        assert (tmp_path / "data" / name).exists(), name
    assert type(stats["graphic_end"]).__name__ == "GraphicEnd2"
    assert len(stats["frame_seconds"]) == 2


def test_image_only_entry_point_needs_a_card_unless_asked_for_the_cpu(dataset, monkeypatch):
    root, _ = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphicEnd2(ParameterReader(None, overrides=overrides(root)))


@pytest.mark.parametrize("name,dim", [("ORB", 256), ("SURF", 64)])
def test_graphic_end2_carries_other_descriptor_widths(dataset, tmp_path, name, dim):
    """A 6-frame image-only run with detector and descriptor `name`: the
    frontend, the keyframe FeatureStore and the batched verifier take
    descriptors D wide, and the run writes the reference's files."""
    root, _ = dataset
    over = dict(overrides(root), detector_name=name, descriptor_name=name)
    ge = GraphicEnd2(ParameterReader(None, overrides=over), data_dir=str(tmp_path), device="cpu")
    slam = SLAMEnd(device="cpu")
    ge.init(slam)
    slam.init(ge)
    for _ in range(5):
        assert ge.run() == 0
    slam.globalOptimizer.save(os.path.join(tmp_path, "final.g2o"))
    ge.save_final_result()
    for f in ("final.g2o", "final_after.g2o", "keyframe.txt", "error_of_transform.log"):
        assert os.path.getsize(tmp_path / f) > 0, f
    assert ge.keyframes[-1].features.desc.shape == (1, 256, dim)
    assert ge.kf_store.gather([0]).desc.shape == (1, 1, 256, dim)
    assert ge.batch_registrar.calls > 0
