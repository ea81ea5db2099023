"""The port's offline CLIs against the JAX package's, on a synthetic
dataset (testing/synthetic.py: a 4-frame 320x240 orbit with its clouds)
and a pose graph of its ground truth with noise.

- generateTrajectory: trajectory.txt byte for byte;
- saveOutput (the port on the CPU) against JAX `fuse_map`: voxel counts
  within 0.1%, and at least 99.9% of each cloud's points matched by the
  other's within 1e-4 m and colors within 1 (testing/clouds.py). The
  centroids are fp32 sums in another order, so one on a voxel's face can
  move to the next voxel;
- convert2PCD: `convert_one` on a synthetic color + depth frame, the
  same points (within 1e-6 m), colors and count; `main` over two frames;
- viewLC: the missing-frames and short-row case of
  tests/test_cli_headless.py, output and images equal to JAX's;
- testRandom: the same 100 draws as JAX's.
"""

import os

import numpy as np
import pytest

from slam3d_gx_torch.cli import convert2pcd as tconvert
from slam3d_gx_torch.cli import generate_trajectory as tgen
from slam3d_gx_torch.cli import save_output as tsave
from slam3d_gx_torch.cli import test_random as trandom
from slam3d_gx_torch.cli import view_lc as tview
from slam3d_gx_torch.config import CameraIntrinsics, ParameterReader as TParams
from slam3d_gx_torch.geometry import se3
from slam3d_gx_torch.io import g2o_io, images, pcd, tum
from slam3d_gx_torch.testing import synthetic
from slam3d_gx_torch.testing.clouds import cloud_agreement
from slam3d_gx_tpu.cli import convert2pcd as jconvert
from slam3d_gx_tpu.cli import generate_trajectory as jgen
from slam3d_gx_tpu.cli import save_output as jsave
from slam3d_gx_tpu.cli import test_random as jrandom
from slam3d_gx_tpu.cli import view_lc as jview
from slam3d_gx_tpu.config import ParameterReader as JParams

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N_FRAMES = 4
LEAF = 0.03  # parameters.yaml's grid_leaf


def params(root):
    over = {"data_source": root, "grid_leaf": LEAF}
    return JParams(None, overrides=over), TParams(None, overrides=over)


@pytest.fixture(scope="module")
def run_outputs(tmp_path_factory):
    """The dataset, and a keyframe.txt and .g2o as a run would leave them:
    keyframes 0-3 on frames 1-4 at the ground truth with noise, and one
    keyframe row whose vertex is missing."""
    root = str(tmp_path_factory.mktemp("orbit"))
    traj = synthetic.orbit_trajectory(N_FRAMES, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR, write_pcd=True)
    rng = np.random.default_rng(5)
    graph = g2o_io.Graph()
    for k, T in enumerate(traj):
        noise = se3.make_isometry(se3.rodrigues(rng.normal(0, 0.01, 3)), rng.normal(0, 0.01, 3))
        graph.add_vertex(k, T @ noise, fixed=k == 0)
        if k:
            graph.add_edge(k - 1, k, se3.inverse(traj[k - 1]) @ T, np.eye(6) * 100)
    g2o_path = os.path.join(root, "final_after.g2o")
    g2o_io.save_g2o(graph, g2o_path)
    kf_path = os.path.join(root, "keyframe.txt")
    tum.write_keyframes(kf_path, [(k, k + 1) for k in range(N_FRAMES)] + [(9, 2)])
    return root, kf_path, g2o_path


def test_generate_trajectory_matches_jax(run_outputs, tmp_path):
    root, kf_path, g2o_path = run_outputs
    jp, tp = params(root)
    assert jgen.generate(kf_path, g2o_path, jp, str(tmp_path / "jax.txt")) == 0
    assert tgen.generate(kf_path, g2o_path, tp, str(tmp_path / "port.txt")) == 0
    port = (tmp_path / "port.txt").read_bytes()
    assert port == (tmp_path / "jax.txt").read_bytes()
    assert len(port.splitlines()) == N_FRAMES


def read_cloud(path):
    xyz, rgba = pcd.read_pcd(path)
    return xyz, np.stack(pcd.unpack_rgba(rgba), -1)


def test_save_output_matches_jax_fuse_map(run_outputs, tmp_path, capsys):
    root, kf_path, g2o_path = run_outputs
    jp, tp = params(root)
    assert jsave.fuse_map(kf_path, g2o_path, 5.0, jp, str(tmp_path / "jax.pcd")) == 0
    assert tsave.fuse_map(kf_path, g2o_path, 5.0, tp, str(tmp_path / "port.pcd"),
                          device="cpu") == 0
    assert capsys.readouterr().out.count("cannot find vertex: 9") == 2
    assert b"DATA ascii" in (tmp_path / "port.pcd").read_bytes()[:400]
    xyz_j, rgb_j = read_cloud(str(tmp_path / "jax.pcd"))
    xyz_t, rgb_t = read_cloud(str(tmp_path / "port.pcd"))
    assert len(xyz_j) > 1000
    assert abs(len(xyz_t) - len(xyz_j)) <= 1e-3 * len(xyz_j)
    assert cloud_agreement(xyz_t, rgb_t, xyz_j, rgb_j, LEAF) >= 0.999
    assert cloud_agreement(xyz_j, rgb_j, xyz_t, rgb_t, LEAF) >= 0.999


def test_save_output_main_needs_two_arguments(capsys):
    assert tsave.main(["keyframe.txt"], device="cpu") == -1
    assert "saveOutput keyframe.txt final.g2o" in capsys.readouterr().out


def synthetic_frame(dirpath, i, rng, h=48, w=64):
    color = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    depth = rng.integers(1, 3000, (h, w)).astype(np.uint16)
    depth[0, :] = 0  # invalid pixels: the first row
    rgb_path = os.path.join(dirpath, "rgb_index", f"{i}.png")
    dep_path = os.path.join(dirpath, "dep_index", f"{i}.png")
    os.makedirs(os.path.dirname(rgb_path), exist_ok=True)
    os.makedirs(os.path.dirname(dep_path), exist_ok=True)
    images.save_color(rgb_path, color)
    images.save_depth(dep_path, depth)
    return rgb_path, dep_path


def test_convert2pcd_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    rgb_path, dep_path = synthetic_frame(str(tmp_path), 1, rng)
    n_j = jconvert.convert_one(rgb_path, dep_path, str(tmp_path / "jax.pcd"))
    n_t = tconvert.convert_one(rgb_path, dep_path, str(tmp_path / "port.pcd"), device="cpu")
    xyz_j, rgba_j = pcd.read_pcd(str(tmp_path / "jax.pcd"))
    xyz_t, rgba_t = pcd.read_pcd(str(tmp_path / "port.pcd"))
    assert n_t == n_j == len(xyz_t) == 47 * 64
    np.testing.assert_allclose(xyz_t, xyz_j, atol=1e-6)
    np.testing.assert_array_equal(rgba_t, rgba_j)


def test_convert2pcd_main_loop(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    for i in (1, 2):
        synthetic_frame(str(tmp_path), i, rng)
    monkeypatch.chdir(tmp_path)
    assert tconvert.main(["1", "3"], device="cpu") == 0
    for i in (1, 2):
        xyz, _ = pcd.read_pcd(f"pcd/{i}.pcd")
        assert xyz.shape[0] == 47 * 64 and (xyz[:, 2] > 0).all()
    assert tconvert.main(["1"], device="cpu") == -1


def test_view_lc_tolerates_missing_frames_and_short_rows(tmp_path, capsys):
    root = tmp_path / "ds"
    rgb = root / "rgb_index"
    rgb.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in (1, 2):
        images.save_gray(str(rgb / f"{i}.png"), rng.integers(0, 255, (48, 64)).astype(np.uint8))
    lc = tmp_path / "lc.txt"
    lc.write_text("1 2 0.5123 41\n"   # 4 columns, frames on disk
                  "7 9 0.3000 25\n"   # frames missing: skipped
                  "2 1 0.4\n"         # 3 columns
                  "5\n"               # malformed: ignored
                  "\n")
    jp, tp = params(str(root))
    assert jview.view(str(lc), params=jp, out_dir=str(tmp_path / "jax")) == 0
    out_j = capsys.readouterr().out
    assert tview.view(str(lc), params=tp, out_dir=str(tmp_path / "port")) == 0
    out = capsys.readouterr().out
    assert out.replace(str(tmp_path / "port"), "") == out_j.replace(str(tmp_path / "jax"), "")
    assert "1 <-> 2" in out and "7 <-> 9" in out and "2 <-> 1" in out
    assert "2 loop closures rendered" in out
    assert sorted(os.listdir(tmp_path / "port")) == ["lc_1_2.png", "lc_2_1.png"]
    for name in ("lc_1_2.png", "lc_2_1.png"):
        np.testing.assert_array_equal(images.load_gray(str(tmp_path / "port" / name)),
                                      images.load_gray(str(tmp_path / "jax" / name)))


@pytest.mark.parametrize("argv", [[], ["7"]])
def test_random_matches_jax(argv, capsys):
    assert jrandom.main(argv) == 0
    out_j = capsys.readouterr().out
    assert trandom.main(argv) == 0
    out = capsys.readouterr().out
    assert out == out_j and len(out.split()) == 100
