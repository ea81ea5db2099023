"""Whole runs of the port against whole runs of the jitted JAX reference, on
the same draws (ROADMAP item 12).

Both packages run the same frontend over the same written dataset: the
JAX one jitted under `jitted_reference()` (tests/test_torch_jaxref.py),
the port on the CPU with its draws replaced by the reference's
(`KeyReplay`): the port frontend's `_uniforms`, its plane sampler and,
streamed, its `_chunk_draws` take each key where the JAX frontend's
`next_key()` takes it. Loop-closure candidates come from
`random.Random(seed)` in both packages. So the two runs make the same
registrations on the same inputs and draws, and are compared frame by
frame. The first frame apart names the stage at fault. Held, with the
tolerances and why:
- the error_of_transform.log rows and so the lost frames (9999) exactly,
  the keyframes exactly, the graph's edges pair for pair;
- per frame the norm and the robot's pose, and streamed each chunk's
  records (`ok`, keyframe, lost counter, rescue flag and inliers exact;
  T, norm and position), within 2e-4. Measured up to 1.1e-4 (the
  streamed plane run's frame 5): the extraction's tolerated differences
  (SIFT descriptor entries +-1, keypoints 1.8e-4 px apart) move a
  correspondence across the final solve's 3 px gate, with the same
  inlier count. The port's registration on the JAX features is within
  7e-6 of JAX's;
- the final poses of the optimized graph within 1e-3 m (measured
  4.3e-4 m): one loop-closure registration of the plane run (keyframes 2
  -> 5) draws a triplet whose P3P quartic is ill-conditioned. The
  jitted JAX reference resolves 146 of that solve's 710 candidates more
  than 1e-3 away from its own eager run, and the port's, in another
  order, lands elsewhere too. In the default "tiered" mode that
  per-plane solve is not polished, so the pooled inlier mask takes 32
  inliers in the port and 33 in JAX, and the edge is 3.1e-3 apart. A
  known property (ROADMAP queue 3), not a fault;
- ATE and RPE within 1e-4 m.

One draw site cannot be mirrored exactly: when the plane frontend's
last-frame rescue promotes the last frame, the reference registers the
keyframe against it again (a fresh draw) and adds that result as the
edge unchecked, where the port reuses the registration that accepted
the last frame (a deliberate delta, the port's graphic_end.py
docstring). The replay skips that key, so the draws stay aligned and
every later registration is still held, but the edge differs: after a
rescue a run is held on its decisions and registrations as above and
on its final poses within 5e-3 m only. The outcome records the frames
where that happened.

The configurations are the orbits of tests/test_torch_slam.py (planes,
SIFT/SIFT, 7 frames) and tests/test_e2e.py (image-only, GFTT/SIFT, 12
frames, tests/test_torch_wholerun_image.py) at 320x240, 256 keypoints
and 128 hypotheses, per frame and streamed in chunks of 3 and 4. No
rescue happens in them. The run helpers below also serve the seed protocol
(tests/test_torch_seed_protocol.py).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from test_torch_jaxref import KeyReplay, jitted_reference

# -- run helpers shared with the seed protocol ------------------------------------


def _outcome(ge, traj, start: int, extra: dict) -> dict:
    from slam3d_gx_torch.testing import synthetic

    rows = open(os.path.join(ge.data_dir, "error_of_transform.log")).read().split()
    est = [np.asarray(ge.opt.vertex_estimate(k.id), np.float64) for k in ge.keyframes]
    gt = [traj[k.frame_index - 1] for k in ge.keyframes]
    out = dict(keyframes=[int(k.frame_index) for k in ge.keyframes],
               lost=[start + 1 + i for i, r in enumerate(rows) if r == "9999"],
               rows=rows, poses=est, ate=float(synthetic.ate_rmse(gt, est)),
               edges=[(e.id1, e.id2, np.asarray(e.T, np.float64)) for e in ge.opt.graph.edges],
               rpe=synthetic.rpe_rmse(gt, est))
    out.update(extra)
    return out


def _drive(ge, slam, frames: int, chunk, get_recs) -> dict:
    """Run the frontend for `frames` frames after init, per frame (chunk
    None: the robot, lost counter and keyframe count after each run()) or
    streamed (each applied chunk's records), then save_final_result."""
    ge.init(slam)
    slam.init(ge)
    per_frame, chunks = [], []
    if chunk is None:
        for _ in range(frames):
            ge.run()
            per_frame.append((np.asarray(ge.robot, np.float64).copy(), int(ge.lost),
                              len(ge.keyframes)))
    else:
        process = ge._process_chunk

        def recorded(st):
            chunks.append((list(st["indices"]), get_recs(st)[:len(st["indices"])].copy()))
            return process(st)

        ge._process_chunk = recorded
        assert ge.run_streaming(frames) == frames
    ge.save_final_result()
    return dict(per_frame=per_frame, chunks=chunks)


def jax_run(root, over: dict, frames: int, image_only: bool, traj, data_dir: str,
            chunk=None) -> dict:
    """The JAX frontend, jitted under the hint."""
    from slam3d_gx_tpu.backend import SLAMEnd
    from slam3d_gx_tpu.config import ParameterReader
    from slam3d_gx_tpu.frontend import GraphicEnd, GraphicEnd2
    from slam3d_gx_tpu.frontend import streaming

    params = ParameterReader(None, overrides=dict(over, data_source=root))
    with jitted_reference():
        if chunk is None:
            cls = GraphicEnd2 if image_only else GraphicEnd
            ge = cls(params, data_dir=data_dir)
        else:
            cls = streaming.StreamingGraphicEnd2 if image_only else streaming.StreamingGraphicEnd
            ge = cls(params, data_dir=data_dir, chunk=chunk)
        rec = _drive(ge, SLAMEnd(), frames, chunk, lambda st: np.asarray(st["recs"]))
    return _outcome(ge, traj, ge.start_index, dict(rec, deltas=[]))


def port_run(root, over: dict, frames: int, image_only: bool, traj, data_dir: str,
             chunk=None, replay: bool = True) -> dict:
    """The port's frontend on the CPU; with `replay`, on the reference's
    draws (module docstring)."""
    from slam3d_gx_torch.backend import SLAMEnd
    from slam3d_gx_torch.config import ParameterReader
    from slam3d_gx_torch.frontend import GraphicEnd, GraphicEnd2
    from slam3d_gx_torch.frontend import streaming
    from slam3d_gx_torch.ops import plane_ransac

    params = ParameterReader(None, overrides=dict(over, data_source=root))
    if chunk is None:
        ge = (GraphicEnd2 if image_only else GraphicEnd)(params, data_dir=data_dir, device="cpu")
    else:
        cls = streaming.StreamingGraphicEnd2 if image_only else streaming.StreamingGraphicEnd
        ge = cls(params, data_dir=data_dir, chunk=chunk, device="cpu")
    deltas = []
    sampler = plane_ransac.UniformSampler
    if replay:
        rep = KeyReplay(ge.seed, ge.hypotheses, None if image_only else ge.max_planes)
        ge._uniforms = rep.uniforms
        if chunk is not None:
            ge._chunk_draws = lambda: rep.chunk_draws(rep.next_key(), ge.chunk)
        plane_ransac.UniformSampler = rep.sampler
        if not image_only:
            rescue = ge._rescue_with_last

            def mirrored_rescue(present):
                carried = ge._last_reg is not None and ge._last_reg[0] == ge.curr_kf.id
                rescue(present)
                if carried and ge.lost == 0:
                    rep.next_key()  # the reference's keyframe -> last registration
                    deltas.append(ge.index)

            ge._rescue_with_last = mirrored_rescue
    try:
        rec = _drive(ge, SLAMEnd(device="cpu"), frames, chunk, lambda st: st["recs"].numpy())
    finally:
        plane_ransac.UniformSampler = sampler
    if chunk is not None:
        # a streamed rescue writes the carried registration, when there is
        # one, as the keyframe->last record (the same delta)
        deltas += [i for indices, recs in rec["chunks"] for i, r in zip(indices, recs)
                   if r[24] != 0.0]
    return _outcome(ge, traj, ge.start_index, dict(rec, deltas=sorted(deltas)))


# per-frame T, norm and robot position; the final poses; ATE and RPE
TOL_T, TOL_POSE, TOL_ATE = 2e-4, 1e-3, 1e-4
TOL_POSE_DELTA = 5e-3  # final poses after the rescue's delta (module docstring)


def hold(port: dict, ref: dict) -> None:
    """Holds a port run to the reference run on the same draws, frame by
    frame (module docstring); the message names the first frame apart."""
    assert len(port["rows"]) == len(ref["rows"]), (port["rows"], ref["rows"])
    for k, (a, b) in enumerate(zip(port["rows"], ref["rows"])):
        assert (a == "9999") == (b == "9999"), f"frame {k + 2}: log row {a} against {b}"
        if a != "9999":
            assert abs(float(a) - float(b)) <= TOL_T, f"frame {k + 2}: norm {a} against {b}"
    for k, ((ra, la, ka), (rb, lb, kb)) in enumerate(zip(port["per_frame"], ref["per_frame"])):
        assert (la, ka) == (lb, kb), f"frame {k + 2}: lost {la} against {lb}, keyframes {ka}/{kb}"
        assert np.abs(ra - rb).max() <= TOL_T, f"frame {k + 2}: robot off by {np.abs(ra - rb).max()}"
    assert len(port["per_frame"]) == len(ref["per_frame"])
    assert [i for i, _ in port["chunks"]] == [i for i, _ in ref["chunks"]]
    for (ia, ra), (_, rb) in zip(port["chunks"], ref["chunks"]):
        for idx, a, b in zip(ia, ra, rb):
            # inliers, ok, new keyframe, lost counter; rescued
            assert np.array_equal(a[17:21], b[17:21]) and a[24] == b[24], (idx, a[17:25], b[17:25])
            off = max(np.abs(a[:17] - b[:17]).max(), np.abs(a[21:24] - b[21:24]).max())
            assert off <= TOL_T, f"frame {idx}: T, norm or position off by {off}"
    assert port["keyframes"] == ref["keyframes"] and port["lost"] == ref["lost"]
    assert [e[:2] for e in port["edges"]] == [e[:2] for e in ref["edges"]]
    tol = TOL_POSE_DELTA if port["deltas"] else TOL_POSE
    off = max(np.abs(a - b).max() for a, b in zip(port["poses"], ref["poses"]))
    assert off <= tol, f"final poses off by {off}"
    assert port["ate"] == pytest.approx(ref["ate"], abs=TOL_ATE)
    assert port["rpe"] == pytest.approx(ref["rpe"], abs=TOL_ATE)


def summary(name: str, port: dict, ref: dict, seconds) -> str:
    return (f"{name}: keyframes {port['keyframes']} / {ref['keyframes']}, lost {port['lost']} / "
            f"{ref['lost']}, ATE {port['ate']:.6f} / {ref['ate']:.6f} m, RPE {port['rpe']:.6f} / "
            f"{ref['rpe']:.6f} m (port / JAX); CPU walls {seconds[0]:.1f} s / {seconds[1]:.1f} s")


# -- the tier-1 holds: the plane frontend ---------------------------------------

CAM = dict(camera_fx=260.0, camera_fy=260.0, camera_cx=160.0, camera_cy=120.0,
           camera_factor=5000.0)
RUN = dict(descriptor_name="SIFT", max_keypoints=256, ransac_hypotheses=128,
           max_pos_change=0.05, end_index=100, grid_leaf=0.05, **CAM)
PLANE_FRAMES = 7


def write_orbit(root: str, traj) -> str:
    from slam3d_gx_torch.config import CameraIntrinsics
    from slam3d_gx_torch.testing import synthetic

    intr = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, intr, write_pcd=True)
    return root


def both(root, over, frames, image_only, traj, tmp_path, chunk=None):
    """The JAX run and the port's, each with its CPU wall."""
    import time

    t0 = time.perf_counter()
    ref = jax_run(root, over, frames, image_only, traj, str(tmp_path / "jax"), chunk)
    t1 = time.perf_counter()
    port = port_run(root, over, frames, image_only, traj, str(tmp_path / "port"), chunk)
    return port, ref, (time.perf_counter() - t1, t1 - t0)


@pytest.fixture(scope="module")
def plane_orbit(tmp_path_factory):
    from slam3d_gx_torch.testing import synthetic

    traj = synthetic.orbit_trajectory(30, radius=0.25, yaw_amp=0.15)[:PLANE_FRAMES]
    return write_orbit(str(tmp_path_factory.mktemp("orbit")), traj), traj


@pytest.mark.parametrize("chunk", [None, 3], ids=["per_frame", "streamed"])
def test_plane_run_matches_jax(plane_orbit, tmp_path, capsys, chunk):
    """GraphicEnd (SIFT/SIFT), the orbit of tests/test_torch_slam.py."""
    root, traj = plane_orbit
    port, ref, walls = both(root, dict(RUN, detector_name="SIFT"), PLANE_FRAMES - 1, False,
                            traj, tmp_path, chunk)
    with capsys.disabled():
        print("\n" + summary(f"planes, {'per frame' if chunk is None else f'chunks of {chunk}'}",
                              port, ref, walls))
    hold(port, ref)
