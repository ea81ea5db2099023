"""The port's experiment CLIs (exp1_2, exp1, planarFeatures and the two
sweeps) on a written synthetic dataset, held to the JAX package where it
can run here.

The datasets are slam3d_gx_torch.testing.synthetic's room orbit with its
rgb_index/, dep_index/, pcd/ and associate.txt: at 160x120 with 64
keypoints and 32 hypotheses where a result is held to JAX, and at
320x240 with 256 keypoints and 128 hypotheses where the port's CLIs run
end to end (at 160x120 and 64 keypoints GFTT registers these frames
wrongly in both packages). Tolerances and why:
- exp1_2 `n` (GFTT/SIFT and ORB/ORB): the port's `matching_normal`
  against the JAX one with the same draws (the uniforms of the JAX key),
  the JAX one jitted under `jitted_reference()` (tests/test_torch_jaxref.py).
  The inlier sets are equal and T agrees to 1e-4 (fp32
  Gauss-Newton on each side).
- exp1_2 `p` end to end (GFTT/SIFT, frames 1 and 2 at 320x240): the
  port's CLI against the JAX CLI's `matching_planar` on the same inputs
  and draws (the JAX CLI's `split(PRNGKey(seed), 4)`: the plane
  extractions' Gumbel noise from keys 0 and 1, the multiPnP's uniforms
  from key 2, replayed into the port's `planar_draws`): the error row's
  ground truth equal, its translation and rotation errors within 1e-4,
  the inliers exact, T within 1e-4.
- exp1_2 end to end on the port's own draws: the error.log and time.log
  rows have the JAX CLI's schema, and with GFTT the errors against the
  ground truth of frames 1 and 2 are below 0.05 m and 0.05 rad, in both
  modes, with the default seed 0. exp1_2 has no
  norm gate, so a RANSAC that draws no all-inlier triplet returns a wrong
  consensus: with seed 0 ORB/ORB does on this pair, and GFTT does on
  frames 1 and 3 at this size, so those errors are not bounded here;
  chip_smoke.py phase 12 counts the right registrations over 8 seeds.
- exp1: the PNGs exist under the reference's names.
- planarFeatures: the verdicts equal JAX's `classify_planar` keypoint for
  keypoint, with its draws (each keypoint's Gumbel noise, moved with the
  keypoint where top-k orders equal FAST scores differently).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import interop
from slam3d_gx_torch.cli import exp1 as texp1
from slam3d_gx_torch.cli import exp1_2 as texp
from slam3d_gx_torch.cli import exp1_2_sweep, exp1_2_time
from slam3d_gx_torch.cli import planar_features as tplanar
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.io import images
from slam3d_gx_torch.ops.features import fast as tfast
from slam3d_gx_torch.testing import synthetic
from slam3d_gx_tpu.cli import exp1_2 as jexp
from slam3d_gx_tpu.cli import planar_features as jplanar
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.config import ParameterReader as JParams
from slam3d_gx_tpu.ops import pnp as jpnp
from test_torch_jaxref import KeyReplay, ReplaySampler, jitted  # noqa: F401  (a fixture)

H, W, K, HYP = 120, 160, 64, 32
CAM = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)
INTR, TINTR = CameraIntrinsics(**CAM), TorchIntrinsics(**CAM)
# the end-to-end runs: 320x240, 256 keypoints, 128 hypotheses
RUN_CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
RUN = dict(max_keypoints=256, ransac_hypotheses=128, **{f"camera_{k}": v
                                                       for k, v in RUN_CAM.items()})


def write(root, cam, h, w):
    traj = synthetic.orbit_trajectory(12, radius=0.2, yaw_amp=0.1)[:4]
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, TorchIntrinsics(**cam),
                            height=h, width=w, write_pcd=True)
    return root


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write(str(tmp_path_factory.mktemp("room")), CAM, H, W)


@pytest.fixture(scope="module")
def run_dataset(tmp_path_factory):
    return write(str(tmp_path_factory.mktemp("room320")), RUN_CAM, 240, 320)


def frame(root, i):
    return (images.load_gray(os.path.join(root, f"rgb_index/{i}.png")),
            images.load_depth(os.path.join(root, f"dep_index/{i}.png")))


def workdir(path, root, **extra):
    params = dict(data_source=root, detector_name="GFTT", descriptor_name="SIFT", **RUN)
    params.update(extra)
    with open(path / "parameters.yaml", "w") as f:
        f.writelines(f"{k}: {v}\n" for k, v in params.items())
    return path


@pytest.mark.parametrize("detector,descriptor", [("GFTT", "SIFT"), ("ORB", "ORB")])
def test_matching_normal_matches_jax(dataset, monkeypatch, jitted, detector, descriptor):
    (g1, d1), (g2, _) = frame(dataset, 1), frame(dataset, 2)
    key = jax.random.PRNGKey(0)
    solves = []
    solve_pnp = jpnp.solve_pnp_ransac

    def solve(*args, **kw):
        solves.append(solve_pnp(*args, **kw))
        return solves[-1]

    monkeypatch.setattr(jpnp, "solve_pnp_ransac", solve)
    ref_T, ref_inl = jexp.matching_normal(g1, d1, g2, INTR, detector, descriptor, K, HYP, key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (HYP, 3))))
    port = (torch.from_numpy(g1), torch.from_numpy(d1.astype(np.int32)), torch.from_numpy(g2),
            TINTR, detector, descriptor, K)
    T, inl = texp.matching_normal(*port, u)
    *_, res = texp.register_normal(*port, u)
    assert inl == ref_inl >= 6
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(solves[0].inliers))
    np.testing.assert_allclose(T, ref_T, atol=1e-4)


@pytest.fixture(scope="module")
def exp1_2_runs(run_dataset, tmp_path_factory):
    """exp1_2 1 2 GFTT SIFT in both modes, then ORB/ORB n, in one working
    directory (rows append)."""
    work = workdir(tmp_path_factory.mktemp("exp1_2"), run_dataset)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rcs = [texp.main(["1", "2", det, desc, mode], device="cpu")
               for det, desc, mode in (("GFTT", "SIFT", "n"), ("GFTT", "SIFT", "p"),
                                       ("ORB", "ORB", "n"))]
    finally:
        os.chdir(cwd)
    return work, rcs


def test_exp1_2_writes_the_reference_rows(exp1_2_runs):
    work, rcs = exp1_2_runs
    assert rcs == [0, 0, 0]
    rows = [r.split() for r in (work / "data/exp1/error.log").read_text().splitlines()]
    assert len(rows) == 3 and all(len(r) == 7 and r[:2] == ["1", "2"] for r in rows)
    gt_trans, gt_rot, err_trans, err_rot = (np.array([float(r[i]) for r in rows])
                                            for i in range(2, 6))
    assert int(rows[0][6]) >= 12 and int(rows[1][6]) >= 12 and int(rows[2][6]) >= 12
    assert (gt_trans > 0.01).all() and np.allclose(gt_trans, gt_trans[0])
    assert (gt_rot > 0).all()
    assert (err_trans[:2] < 0.05).all() and (err_rot[:2] < 0.05).all(), rows
    labels = [r.split()[0] for r in (work / "data/time.log").read_text().splitlines()]
    assert labels == ["ExtractPlane", "DetectKeypoints", "Descriptor", "Compute3dPosition",
                      "RANSAC"]


def test_exp1_2_planar_matches_jax(run_dataset, tmp_path, monkeypatch, jitted):
    """exp1_2 1 2 GFTT SIFT p: the port's CLI on the reference's draws
    against the JAX CLI's matching_planar."""
    work = workdir(tmp_path, run_dataset)
    monkeypatch.chdir(work)
    jparams = JParams("./parameters.yaml")
    key = jax.random.PRNGKey(jparams.get_int("seed"))
    keys = jax.random.split(key, 4)
    (g1, d1), (g2, d2) = frame(run_dataset, 1), frame(run_dataset, 2)
    cloud = dict(z_max=jparams.get_float("optimize_step"), grid_leaf=jparams.get_float("grid_leaf"),
                 cap=jparams.get_int("cloud_capacity") or int(g1.size), intr=jparams.intrinsics,
                 align_scale=jparams.get_bool("align_cloud_scale"))
    c1 = jexp._load_cloud(os.path.join(run_dataset, "pcd/1.pcd"), depth=d1, **cloud)
    c2 = jexp._load_cloud(os.path.join(run_dataset, "pcd/2.pcd"), depth=d2, **cloud)
    with open(tmp_path / "jax_time.log", "w") as timelog:
        ref_T, ref_inl = jexp.matching_planar(
            g1, d1, *c1, g2, d2, *c2, jparams.intrinsics, jparams, "GFTT", "SIFT",
            jparams.get_int("max_keypoints"), jparams.get_int("ransac_hypotheses"), key,
            timelog)

    planes = jparams.get_int("max_planes")
    rep = KeyReplay(0, jparams.get_int("ransac_hypotheses"), planes=planes)
    draws = (ReplaySampler(keys[0], planes), ReplaySampler(keys[1], planes),
             torch.from_numpy(rep.pair_uniforms(keys[2])))
    monkeypatch.setattr(texp, "planar_draws", lambda params, hypotheses, gen: draws)
    Ts = []
    matching = texp.matching_planar
    monkeypatch.setattr(texp, "matching_planar",
                        lambda *a, **kw: Ts.append(matching(*a, **kw)) or Ts[-1])
    assert texp.main(["1", "2", "GFTT", "SIFT", "p"], device="cpu") == 0
    (T, inl), = Ts
    assert inl == ref_inl
    np.testing.assert_allclose(T, ref_T, atol=1e-4)
    row = (work / "data/exp1/error.log").read_text().split()
    Tr = texp.ground_truth(run_dataset, "1", "2")
    Terr = np.linalg.inv(Tr) @ ref_T
    assert row[:2] == ["1", "2"] and int(row[6]) == ref_inl
    assert float(row[2]) == pytest.approx(float(f"{np.linalg.norm(Tr[:3, 3]):g}"))
    assert float(row[3]) == pytest.approx(float(f"{texp.error_angle(Tr):g}"))
    assert float(row[4]) == pytest.approx(np.linalg.norm(Terr[:3, 3]), abs=1e-4)
    assert float(row[5]) == pytest.approx(texp.error_angle(Terr), abs=1e-4)


def test_exp1_2_rejects_bad_arguments(run_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(workdir(tmp_path, run_dataset))
    assert texp.main(["1", "3", "GFTT", "SIFT"], device="cpu") == -1
    assert texp.main(["1", "3", "GFTT", "SIFT", "x"], device="cpu") == -1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texp.main(["1", "3", "GFTT", "SIFT", "n"])


def test_exp1_writes_the_reference_pngs(run_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(workdir(tmp_path, run_dataset))
    assert texp1.main(["1", "2", "GFTT", "SIFT", "n"], device="cpu") == 0
    assert texp1.main(["1", "2", "GFTT", "SIFT", "p"], device="cpu") == 0
    out = tmp_path / "data/exp1"
    names = set(os.listdir(out))
    assert {"match_1_2.png", "inliers_1_2.png", "error.log", "plane_1_0.png",
            "plane_2_0.png", "plane_match_1_2_0.png", "plane_inliers_1_2_0.png"} <= names
    canvas = images.load_gray(str(out / "match_1_2.png"))
    assert canvas.shape == (240, 640)
    assert len((out / "error.log").read_text().splitlines()) == 2


def test_planar_features_verdicts_match_jax(dataset):
    gray, depth = frame(dataset, 1)
    kps_j, planar_j = jplanar.classify_planar(gray, depth, INTR, max_kp=K, seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), K)
    noise = np.stack([np.asarray(jax.random.gumbel(jax.random.split(k, 1)[0], (64, 3, 49),
                                                   jnp.float32))[None] for k in keys])
    # the port's keypoint i takes the noise of the JAX keypoint at its pixel
    g = torch.from_numpy(gray)
    kps_t = tfast.detect_fast(g, threshold=20.0, max_kp=K)
    slot = {tuple(uv): i for i, uv in enumerate(np.asarray(kps_j.uv).tolist())}
    valid_t = kps_t.valid.numpy()
    perm = np.array([slot[tuple(uv)] if v else i
                     for i, (uv, v) in enumerate(zip(kps_t.uv.numpy().tolist(), valid_t))])
    kps, planar = tplanar.classify_planar(g, torch.from_numpy(depth.astype(np.int32)), TINTR,
                                          interop.plane_sampler(noise[perm], "cpu"), max_kp=K)
    np.testing.assert_array_equal(kps.uv.numpy(), kps_t.uv.numpy())
    np.testing.assert_array_equal(kps.valid.numpy(), np.asarray(kps_j.valid)[perm])
    np.testing.assert_array_equal(planar.numpy(), np.asarray(planar_j)[perm])
    assert planar.sum() > 5


def test_planar_features_cli(run_dataset, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tplanar.main([os.path.join(run_dataset, "rgb_index/1.png"),
                         os.path.join(run_dataset, "dep_index/1.png")], device="cpu") == 0
    assert (tmp_path / "planar_features.png").exists()
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("keypoints:")][0]
    assert int(line.split("planar:")[1]) > 0


def test_sweeps_run_exp1_2_in_process(run_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(workdir(tmp_path, run_dataset, detector_name="FAST"))
    assert exp1_2_sweep.main(["--anchors", "1", "--offsets", "1", "--modes", "n",
                              "--detector", "FAST"], device="cpu") == 0
    assert exp1_2_time.main(["--pairs", "1", "--detectors", "FAST"], device="cpu") == 0
    assert len((tmp_path / "data/exp1/error.log").read_text().splitlines()) == 2
    log = (tmp_path / "data/time.log").read_text().splitlines()
    assert log[0] == "# detector FAST" and len(log) == 6
