"""Scored loop closure and the finalize pre-filter on the port's own
frontend (GraphicEnd2, image-only, GFTT/SIFT at 320x240, on the CPU).
The properties of the JAX package's tests, held on the port:

- tests/test_e2e.py's pre-filter property: with finalize_prefilter at or
  above the keyframe count the final edge set equals that of
  finalize_prefilter: 0; a tight limit prunes pairs and keeps every
  keyframe's sequential edge;
- tests/test_lost_recovery.py's: scored mode closes loops (a blackout
  dataset, lostRecovery included), with the database holding every
  keyframe; streamed too;
- one fused round (candidates chosen on the device, gathered and
  verified with no host wait) against the host path's round on the same
  features and the same draws: the same candidates in the same order and
  the same verdicts.
"""

import os

import numpy as np
import pytest
import torch

from slam3d_gx_torch.backend import SLAMEnd
from slam3d_gx_torch.config import CameraIntrinsics, ParameterReader
from slam3d_gx_torch.frontend import GraphicEnd2
from slam3d_gx_torch.frontend.streaming import StreamingGraphicEnd2
from slam3d_gx_torch.io import images
from slam3d_gx_torch.parallel import registration
from slam3d_gx_torch.testing import synthetic

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N_FRAMES = 12
BLANK = (5, 6, 7)  # frames rendered featureless in the blackout dataset


def write(root, n, blank=()):
    traj = synthetic.orbit_trajectory(n, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR, write_pcd=False)
    for i in blank:  # no keypoints: multiPnP fails
        images.save_gray(os.path.join(root, f"rgb_index/{i}.png"),
                         np.full((240, 320), 120, np.uint8))
    return root


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    return write(str(tmp_path_factory.mktemp("orbit")), N_FRAMES)


@pytest.fixture(scope="module")
def blackout(tmp_path_factory):
    return write(str(tmp_path_factory.mktemp("blackout")), 14, BLANK)


def params(root, **kw):
    over = dict(data_source=root, detector_name="GFTT", descriptor_name="SIFT",
                camera_fx=INTR.fx, camera_fy=INTR.fy, camera_cx=INTR.cx, camera_cy=INTR.cy,
                camera_factor=INTR.factor, max_keypoints=256, ransac_hypotheses=128,
                max_pos_change=0.05, end_index=100, grid_leaf=0.05)
    over.update(kw)
    return ParameterReader(None, overrides=over)


def run(root, datadir, frames, cls=GraphicEnd2, save=True, **kw):
    ge = cls(params(root, **kw), data_dir=str(datadir), device="cpu")
    slam = SLAMEnd(device="cpu")
    ge.init(slam)
    slam.init(ge)
    if cls is GraphicEnd2:
        for _ in range(frames):
            ge.run()
    else:
        ge.run_streaming(frames)
    if save:
        ge.save_final_result()
    return ge


def edges(ge):
    return sorted((e.id1, e.id2) for e in ge.opt.graph.edges)


def test_finalize_prefilter_edge_equivalence(orbit, tmp_path):
    ge0 = run(orbit, tmp_path / "exact", N_FRAMES - 1, finalize_prefilter=0)
    k = len(ge0.keyframes)
    assert ge0.lcdb is None and k >= 5
    ge1 = run(orbit, tmp_path / "wide", N_FRAMES - 1, finalize_prefilter=max(k, 4))
    assert ge1.lcdb is not None and ge1.lcdb.count == k
    assert edges(ge1) == edges(ge0)
    assert ge1._prefilter_pruned == 0
    ge2 = run(orbit, tmp_path / "tight", N_FRAMES - 1, finalize_prefilter=2)
    assert ge2._prefilter_pruned > 0
    present = set(edges(ge2))
    ids = [kf.id for kf in ge2.keyframes]
    for a, b in zip(ids, ids[1:]):
        assert (a, b) in present or (b, a) in present


@pytest.fixture(scope="module")
def scored_run(blackout, tmp_path_factory):
    datadir = tmp_path_factory.mktemp("data_scored")
    ge = run(blackout, datadir, 13, save=False, loop_closure_scored=1, lost_frames=1)
    return ge, datadir


def lc_rows(datadir):
    path = os.path.join(datadir, "lc.txt")
    return [r for r in open(path).read().splitlines() if r.strip()] if os.path.exists(path) else []


def test_scored_loop_closure_mode(scored_run):
    ge, datadir = scored_run
    assert ge.lcdb is not None and ge.lcdb.count == len(ge.keyframes)
    assert any(ent[0] == "fused" for ent in ge._pending_lc) or lc_rows(datadir)
    ge.drain_pending_loop_closures()
    assert len(lc_rows(datadir)) >= 1  # scored retrieval found verifiable loops
    assert os.path.exists(os.path.join(datadir, "lost.txt"))


def test_scored_loop_closure_streamed(orbit, tmp_path):
    ge = run(orbit, tmp_path, N_FRAMES - 1, cls=StreamingGraphicEnd2, save=False,
             loop_closure_scored=1, finalize_prefilter=4)
    assert ge.lcdb.count == len(ge.keyframes) >= 5
    ge.drain_pending_loop_closures()
    assert len(lc_rows(tmp_path)) >= 1


def test_fused_round_matches_host_round(scored_run):
    ge, _ = scored_run
    q = ge.curr_kf.features
    n = ge.loopclosure_frames
    idx, valid = ge.lcdb.select_candidates_device(q, n, n_det=ge._LC_N_DET)
    u = ge._uniforms(idx.shape[0])
    fused = registration.fetch_all([ge.batch_registrar.dispatch_fused(
        ge.kf_store, idx, valid, q, u, ge.loop_closure_inliers)])[0]
    count = len(ge.keyframes)
    nearby = [count + i for i in (-3, -4) if count + i >= 0]
    cand = nearby + ge.lcdb.top_candidates(q, n)
    keep = valid.numpy()
    assert [int(i) for i in idx.numpy()[keep]] == cand
    np.testing.assert_array_equal(fused[keep, 19], cand)
    host = ge.batch_registrar.run_against_one(ge.kf_store, cand, q, u[torch.from_numpy(keep)],
                                              ge.loop_closure_inliers)
    for row, (T, norm, inl, ok) in zip(fused[keep], host):
        T_f, norm_f, inl_f, ok_f = registration.unpack_result_row(row[:19])
        assert (ok_f, inl_f) == (ok, inl)
        assert ge._passes(norm_f, inl_f, ok_f) == ge._passes(norm, inl, ok)
        np.testing.assert_allclose(T_f, T, atol=1e-5)
