"""The port's streaming tracker (frontend/streaming.py) against the JAX
package's, and its frontends against the port's per-frame path, on the
CPU.

- The scripted chunk of tests/test_streaming.py (one frame rescued
  against the last frame, two lost): the JAX `build_tracker` (jitted)
  and the port's, each with deterministic stubs of the extractor and of
  multiPnP, give the same 59-column records to 1e-5 and the same carry,
  with and without the rescue. The port's tracker also registers the
  keyframe against `last` only when it carries no registration of it.
- Real chunks against the JAX tracker, jitted under `jitted_reference()`
  (tests/test_torch_jaxref.py), given the same draws
  (`interop.chunk_draws`, or the replay of tests/test_torch_jaxref.py):
  an image-only chunk of 3 frames (320x240, GFTT + SIFT, 256 keypoints,
  128 hypotheses) and a plane chunk of 3 frames (SIFT + SIFT, the
  streaming extractor's backprojected cloud, the reference's Gumbel
  draws, the rescue on): `ok`, `new_kf`, `lost`, the rescue flag and the
  inlier counts exact; T, norm and the robot's position within 1e-4,
  the multiPnP tolerance of tests/test_torch_imageonly.py.
- The plane chunk is also held against the port's own per-frame stages
  on the same draws, record for record.
- The JAX package's streaming tests, ported to the port's frontends on
  `device="cpu"` (13-frame 320x240 orbit): streamed against per-frame
  decisions and ATE, the plane pipeline, odometry edges, a blackout
  through lostRecovery, chunk 1, the host mirror of a rescue record.
- The streaming CLI runs on the CPU when asked and raises without a card
  otherwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam3d_gx_torch import interop
from slam3d_gx_torch.backend import SLAMEnd
from slam3d_gx_torch.cli import run_slam_streaming
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.config import ParameterReader
from slam3d_gx_torch.frontend import GraphicEnd, GraphicEnd2
from slam3d_gx_torch.frontend import pipeline as tpipe
from slam3d_gx_torch.frontend import streaming as tstream
from slam3d_gx_torch.frontend.state import FrameFeatures as TFeatures
from slam3d_gx_torch.frontend.state import MultiPnPResult as TResult
from slam3d_gx_torch.geometry import se3
from slam3d_gx_torch.io import images as img_io
from slam3d_gx_torch.testing import synthetic
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.config import ParameterReader as JParams
from slam3d_gx_tpu.frontend import pipeline as jpipe
from slam3d_gx_tpu.frontend import streaming as jstream
from slam3d_gx_tpu.frontend.state import FrameFeatures as JFeatures
from slam3d_gx_tpu.frontend.state import MultiPnPResult as JResult
from test_torch_jaxref import KeyReplay, ReplaySampler, jitted  # noqa: F401  (a fixture)

INTR = TorchIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
JINTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N = 13  # 12 processed frames; chunk=5 leaves a 2-frame tail path
HYP = 128


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream"))
    traj = synthetic.orbit_trajectory(N, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR, write_pcd=True)
    return root, traj


def _overrides(root, **kw):
    over = dict(
        data_source=root, detector_name="GFTT", descriptor_name="SIFT",
        camera_fx=INTR.fx, camera_fy=INTR.fy, camera_cx=INTR.cx,
        camera_cy=INTR.cy, camera_factor=INTR.factor,
        max_keypoints=256, ransac_hypotheses=HYP,
        max_pos_change=0.05, end_index=100,
    )
    over.update(kw)
    return over


def _params(root, **kw):
    return ParameterReader(None, overrides=_overrides(root, **kw))


def _start(ge):
    slam = SLAMEnd(device="cpu")
    ge.init(slam)
    slam.init(ge)
    return ge


def _ate(ge, traj):
    est = [ge.opt.vertex_estimate(k.id) for k in ge.keyframes]
    gt = [traj[k.frame_index - 1] for k in ge.keyframes]
    return synthetic.ate_rmse(gt, est)


def _log_rows(ge):
    return open(os.path.join(ge.data_dir, "error_of_transform.log")).read().split()


# -- the scripted chunk: JAX tracker against the port's, with stubs ------------

# frame "values", the keyframe starting at 0: f0 0.5 ok; f1 1.0 ok; f2 2.4
# fails against kf 0 and, with the rescue, is rescued against last 1.0;
# f3 2.6 ok (against 2.4 with the rescue); f4 9.0 and f5 9.2 fail both ways
SCRIPT = [0.5, 1.0, 2.4, 2.6, 9.0, 9.2]


def _jax_tracker_run(rescue):
    def mkfeat(v):
        return JFeatures(coeffs=jnp.full((1, 4), v, jnp.float32),
                         plane_valid=jnp.ones((1,), bool), uv=jnp.zeros((1, 4, 2), jnp.float32),
                         kp3d=jnp.zeros((1, 4, 3), jnp.float32),
                         desc=jnp.zeros((1, 4, 8), jnp.float32),
                         kp_valid=jnp.ones((1, 4), bool))

    def multipnp(a, b, key, min_inl):
        d = jnp.abs(b.coeffs[0, 0] - a.coeffs[0, 0])
        ok = d < 1.5
        T = jnp.eye(4, dtype=jnp.float32).at[0, 3].set(d)
        return JResult(T=T, norm=jnp.where(ok, 0.01 * d, jnp.float32(7.0)),
                       inliers=jnp.where(ok, jnp.int32(50), jnp.int32(5)), ok=ok)

    chunk = len(SCRIPT)
    tracker = jstream.build_tracker(lambda g, d, k: mkfeat(g[0, 0]), multipnp,
                                    max_pos_change=0.05, chunk=chunk, rescue=rescue,
                                    rescue_inliers=30, rescue_error=1.5)
    eye = jnp.eye(4, dtype=jnp.float32)
    carry, _, recs = tracker(mkfeat(0.0), eye, eye, jnp.int32(0), mkfeat(0.0),
                             jnp.stack([jnp.full((2, 2), v, jnp.float32) for v in SCRIPT]),
                             jnp.zeros((chunk, 2, 2), jnp.float32),
                             jax.random.split(jax.random.PRNGKey(0), chunk))
    return carry, np.asarray(recs)


def _port_tracker_run(rescue, calls):
    def mkfeat(v):
        v = torch.as_tensor(v, dtype=torch.float32)
        return TFeatures(coeffs=torch.full((1, 4), float(v)), plane_valid=torch.ones(1, dtype=bool),
                         uv=torch.zeros(1, 4, 2), kp3d=torch.zeros(1, 4, 3),
                         desc=torch.zeros(1, 4, 8), kp_valid=torch.ones(1, 4, dtype=bool))

    def multipnp(a, b, u, min_inl):
        calls.append(min_inl)
        d = torch.abs(b.coeffs[0, 0] - a.coeffs[0, 0])
        ok = d < 1.5
        T = torch.eye(4)
        T[0, 3] = d
        return TResult(T=T, norm=torch.where(ok, 0.01 * d, 7.0),
                       inliers=torch.where(ok, 50, 5), ok=ok)

    chunk = len(SCRIPT)
    tracker = tstream.build_tracker(lambda g, d, s: mkfeat(g[0, 0]), multipnp,
                                    max_pos_change=0.05, chunk=chunk, rescue=rescue,
                                    rescue_inliers=30, rescue_error=1.5)
    carry = tstream.TrackCarry(mkfeat(0.0), torch.eye(4), torch.eye(4),
                               torch.tensor(0, dtype=torch.int32), mkfeat(0.0),
                               torch.eye(4), torch.tensor(False))
    grays = torch.stack([torch.full((2, 2), v) for v in SCRIPT])
    draws = tstream.ChunkDraws(None, torch.zeros(chunk, 3, 1))
    carry, feats, recs = tracker(carry, grays, torch.zeros(chunk, 2, 2), draws)
    assert feats.coeffs.shape == (chunk, 1, 4)
    return carry, recs.numpy()


@pytest.mark.parametrize("rescue", [True, False])
def test_scripted_chunk_records_match_jax(rescue):
    jcarry, jrecs = _jax_tracker_run(rescue)
    calls = []
    tcarry, trecs = _port_tracker_run(rescue, calls)
    assert tstream.REC_WIDTH == 59 and trecs.shape == jrecs.shape == (len(SCRIPT), 59)
    np.testing.assert_allclose(trecs, jrecs, atol=1e-5)
    for j_field, t_field in ((jcarry[0], tcarry.kf_feat), (jcarry[4], tcarry.last_feat)):
        for a, b in zip(j_field, t_field):
            np.testing.assert_allclose(b.numpy().astype(np.float64),
                                       np.asarray(a).astype(np.float64), atol=1e-5)
    assert int(tcarry.lost) == int(jcarry[3])
    np.testing.assert_allclose(tcarry.robot.numpy(), np.asarray(jcarry[2]), atol=1e-5)
    if rescue:
        assert list(trecs[:, 24]) == [0, 0, 1, 0, 0, 0]
        assert list(trecs[:, 20]) == [0, 0, 0, 0, 1, 2]
        # each failed frame registers against last only: the keyframe ->
        # last registration is the carried one that accepted last (JAX
        # registers that pair again, twice more here)
        assert len(calls) == len(SCRIPT) + 3
    else:
        assert not trecs[:, 24:].any() and len(calls) == len(SCRIPT)


# -- a real image-only chunk: JAX tracker against the port's -----------------

def _render(root, idx):
    gray = img_io.load_gray(os.path.join(root, "rgb_index", f"{idx}.png"))
    depth = img_io.load_depth(os.path.join(root, "dep_index", f"{idx}.png"))
    return np.asarray(gray), np.asarray(depth)


def _frame_draws(keys, reg_uniforms, gumbel=None):
    """Per frame of a chunk, the draws of the JAX step from its key."""
    out = []
    for key in keys:
        k_ext, k_pnp, k_r, k_rr = jax.random.split(key, 4)
        f = {"pnp": reg_uniforms(k_pnp), "rescue": reg_uniforms(k_r),
             "keyframe_last": reg_uniforms(k_rr)}
        if gumbel is not None:
            f["gumbel"] = gumbel(k_ext)
        out.append(f)
    return out


def test_image_chunk_decisions_match_jax(dataset, jitted):
    root, _ = dataset
    frames = [_render(root, i) for i in (1, 2, 3, 4)]
    frames = [(g.copy(), d) for g, d in frames]
    grays = np.stack([g for g, _ in frames[1:]])
    depths = np.stack([d for _, d in frames[1:]])
    keys = jax.random.split(jax.random.PRNGKey(5), 3)

    jext = jpipe.build_image_extractor("GFTT", "SIFT", JINTR, max_kp=256)
    jkf = jext(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]))
    jtracker = jstream.build_tracker(lambda g, d, k: jext(g, d),
                                     jpipe.build_multipnp_image(JINTR, hypotheses=HYP),
                                     max_pos_change=0.05, chunk=3)
    eye = jnp.eye(4, dtype=jnp.float32)
    _, _, jrecs = jtracker(jkf, eye, eye, jnp.int32(0), jkf, jnp.asarray(grays),
                           jnp.asarray(depths), keys)
    jrecs = np.asarray(jrecs)
    draws = interop.chunk_draws(
        _frame_draws(keys, lambda k: np.asarray(jax.random.uniform(k, (HYP, 3)))), "cpu")

    text = tpipe.build_image_extractor("GFTT", "SIFT", INTR, max_kp=256)
    tkf = text(torch.from_numpy(frames[0][0]), torch.from_numpy(frames[0][1].astype(np.int32)))
    ttracker = tstream.build_tracker(lambda g, d, s: text(g, d),
                                     tpipe.build_multipnp_image(INTR),
                                     max_pos_change=0.05, chunk=3)
    carry = tstream.TrackCarry(tkf, torch.eye(4), torch.eye(4),
                               torch.tensor(0, dtype=torch.int32), tkf, torch.eye(4),
                               torch.tensor(False))
    _, feats, trecs = ttracker(carry, torch.from_numpy(grays),
                               torch.from_numpy(depths.astype(np.int32)), draws)
    trecs = trecs.numpy()
    assert feats.uv.shape == (3, 1, 256, 2)
    np.testing.assert_array_equal(trecs[:, 17:21], jrecs[:, 17:21])  # inliers ok new_kf lost
    assert jrecs[:, 18].sum() >= 1  # a frame was tracked
    np.testing.assert_allclose(trecs[:, :17], jrecs[:, :17], atol=1e-4)  # T, norm
    np.testing.assert_allclose(trecs[:, 21:24], jrecs[:, 21:24], atol=1e-4)  # robot t
    assert not trecs[:, 24:].any() and not jrecs[:, 24:].any()


def test_plane_chunk_decisions_match_jax(dataset, tmp_path, jitted):
    """A real plane chunk of 3 frames, the rescue on, against the JAX
    tracker of the JAX StreamingGraphicEnd on the same draws."""
    root, _ = dataset
    frames = [_render(root, i) for i in (1, 2, 3, 4)]
    grays = np.stack([g for g, _ in frames[1:]])
    depths = np.stack([d for _, d in frames[1:]])
    kf_key, chunk_key = jax.random.split(jax.random.PRNGKey(9))

    jge = jstream.StreamingGraphicEnd(JParams(None, overrides=_overrides(root)),
                                      data_dir=str(tmp_path / "j"), chunk=3)
    jext = jge._make_extract_fn()
    jkf = jext(jnp.asarray(frames[0][0], jnp.float32), jnp.asarray(frames[0][1], jnp.float32),
               kf_key)
    jtracker = jstream.build_tracker(jext, jge.multipnp, 0.05, 3, rescue=True,
                                     rescue_inliers=jge.loop_closure_inliers,
                                     rescue_error=jge.loop_closure_error)
    eye = jnp.eye(4, dtype=jnp.float32)
    _, _, jrecs = jtracker(jkf, eye, eye, jnp.int32(0), jkf, jnp.asarray(grays),
                           jnp.asarray(depths), jax.random.split(chunk_key, 3))
    jrecs = np.asarray(jrecs)

    ge = tstream.StreamingGraphicEnd(_params(root), data_dir=str(tmp_path / "t"), chunk=3,
                                     device="cpu")
    ext = ge._make_extract_fn()
    tkf = ext(torch.from_numpy(frames[0][0]), torch.from_numpy(frames[0][1].astype(np.int32)),
              ReplaySampler(kf_key, ge.max_planes))
    tracker = tstream.build_tracker(ext, ge._multipnp, 0.05, 3, rescue=True,
                                    rescue_inliers=ge.loop_closure_inliers,
                                    rescue_error=ge.loop_closure_error)
    carry = tstream.TrackCarry(tkf, torch.eye(4), torch.eye(4), torch.tensor(0, dtype=torch.int32),
                               tkf, torch.eye(4), torch.tensor(False))
    _, feats, trecs = tracker(carry, torch.from_numpy(grays),
                              torch.from_numpy(depths.astype(np.int32)),
                              KeyReplay(0, HYP, planes=ge.max_planes).chunk_draws(chunk_key, 3))
    trecs = trecs.numpy()
    assert int(feats.plane_valid[0].sum()) >= 1
    np.testing.assert_array_equal(trecs[:, 17:21], jrecs[:, 17:21])  # inliers ok new_kf lost
    np.testing.assert_array_equal(trecs[:, 24], jrecs[:, 24])  # rescued
    assert jrecs[:, 18].sum() >= 1
    np.testing.assert_allclose(trecs[:, :17], jrecs[:, :17], atol=1e-4)  # T, norm
    np.testing.assert_allclose(trecs[:, 21:24], jrecs[:, 21:24], atol=1e-4)  # robot t


# -- a plane chunk against the port's own per-frame stages -----------------------

def test_plane_chunk_matches_per_frame_stages(dataset, tmp_path):
    """The tracker over 2 plane frames equals, record for record, the
    per-frame stages it strings together (the streaming extractor's
    backprojected cloud, the plane extractor, multiPnP, the keyframe
    decision and the last-frame rescue) run one by one on the same
    draws."""
    root, _ = dataset
    ge = tstream.StreamingGraphicEnd(_params(root), data_dir=str(tmp_path), chunk=2,
                                     device="cpu")
    ext, mp = ge._make_extract_fn(), ge._multipnp
    t = [(torch.from_numpy(g.copy()), torch.from_numpy(d.astype(np.int32)))
         for g, d in (_render(root, i) for i in (1, 2, 3))]
    rng = np.random.default_rng(3)
    draws = [{"gumbel": rng.gumbel(size=(3, HYP, 3, tpipe.PLANE_POINTS)).astype(np.float32),
              "pnp": rng.random((5, HYP, 3)), "rescue": rng.random((5, HYP, 3)),
              "keyframe_last": rng.random((5, HYP, 3))} for _ in range(3)]
    kf = last = ext(*t[0], interop.plane_sampler(draws[2]["gumbel"], "cpu"))
    chunk = interop.chunk_draws(draws[:2], "cpu")
    tracker = tstream.build_tracker(ext, mp, 0.05, 2, rescue=True)
    carry = tstream.TrackCarry(kf, torch.eye(4), torch.eye(4), torch.tensor(0, dtype=torch.int32),
                               kf, torch.eye(4), torch.tensor(False))
    _, feats, recs = tracker(carry, torch.stack([g for g, _ in t[1:]]),
                             torch.stack([d for _, d in t[1:]]), chunk)
    recs = recs.numpy()
    assert int(feats.plane_valid[0].sum()) >= 1
    robot, reg = np.eye(4), None
    for j in range(2):
        feat = ext(*t[j + 1], chunk.samplers[j])
        for a, b in zip(feat, feats):
            assert torch.equal(a, b[j])
        res = mp(kf, feat, chunk.u[j, 0], 12)
        T = se3.inverse(res.T.numpy().astype(np.float64))
        ok = bool(res.ok)
        np.testing.assert_allclose(recs[j, :16], T.reshape(16), atol=1e-5)
        assert recs[j, 16] == pytest.approx(float(res.norm), abs=1e-6)
        assert recs[j, 17] == int(res.inliers) and recs[j, 18] == ok
        assert recs[j, 19] == (ok and float(res.norm) > 0.05)
        if ok:
            robot = T @ robot
            kf, reg = (feat, None) if recs[j, 19] else (kf, res.T)
            last = feat
        else:
            # the rescue against last; keyframe -> last is the carried
            # registration when there is one
            r = mp(last, feat, chunk.u[j, 1], 12)
            r_ok = bool(r.ok) and int(r.inliers) >= 30 and float(r.norm) <= 1.5
            rr = reg if reg is not None else mp(kf, last, chunk.u[j, 2], 12).T
            assert recs[j, 24] == r_ok
            np.testing.assert_allclose(recs[j, 25:41], r.T.reshape(16).numpy(), atol=1e-6)
            np.testing.assert_allclose(recs[j, 41:43], [float(r.norm), int(r.inliers)],
                                       atol=1e-6)
            np.testing.assert_allclose(recs[j, 43:59], rr.reshape(16).numpy(), atol=1e-6)
            if r_ok:
                kf, last, reg = feat, feat, None
        np.testing.assert_allclose(recs[j, 21:24], robot[:3, 3], atol=1e-5)


# -- the JAX package's streaming tests, on the port's frontends ----------------

def test_streaming_matches_per_frame(dataset, tmp_path_factory):
    root, traj = dataset
    ge = _start(GraphicEnd2(_params(root), data_dir=str(tmp_path_factory.mktemp("pf")),
                            device="cpu"))
    for _ in range(N - 1):
        ge.run()
    ge.save_final_result()

    gs = _start(tstream.StreamingGraphicEnd2(
        _params(root), data_dir=str(tmp_path_factory.mktemp("st")), chunk=5, device="cpu"))
    assert gs.run_streaming(N - 1) == N - 1
    gs.save_final_result()
    # 2 full chunks and a tail of 2 padded to 5, plus init's extraction
    assert gs.dispatches == 3 and gs.extractions == 1 + 3 * 5

    # same decisions (the draws differ, so one keyframe of slack)
    kf1 = [k.frame_index for k in ge.keyframes]
    kf2 = [k.frame_index for k in gs.keyframes]
    assert abs(len(kf1) - len(kf2)) <= 1, (kf1, kf2)
    for g in (ge, gs):
        assert _ate(g, traj) < 0.05
        assert len(_log_rows(g)) == N - 1
        assert os.path.exists(os.path.join(g.data_dir, "keyframe.txt"))


def test_streaming_planes(dataset, tmp_path_factory):
    """StreamingGraphicEnd: the plane pipeline tracked in chunks;
    decisions line up with the per-frame GraphicEnd."""
    root, traj = dataset
    ge = _start(GraphicEnd(_params(root), data_dir=str(tmp_path_factory.mktemp("ppf")),
                           device="cpu"))
    for _ in range(N - 1):
        ge.run()

    gs = _start(tstream.StreamingGraphicEnd(
        _params(root), chunk=5, data_dir=str(tmp_path_factory.mktemp("pst")), device="cpu"))
    assert gs.run_streaming(N - 1) == N - 1
    gs.save_final_result()
    kf1 = [k.frame_index for k in ge.keyframes]
    kf2 = [k.frame_index for k in gs.keyframes]
    assert abs(len(kf1) - len(kf2)) <= 1, (kf1, kf2)
    assert _ate(gs, traj) < 0.06
    assert len(_log_rows(gs)) == N - 1


def test_streaming_odometry_edges(dataset, tmp_path_factory):
    """use_odometry in streaming mode: odo_this advances per applied
    frame, so keyframes get the odometry edge at 1/sigma^2 like the
    per-frame path (reference src/GraphicEnd.cpp:330-346)."""
    root, _ = dataset
    gs = _start(tstream.StreamingGraphicEnd2(
        _params(root, use_odometry="yes"), chunk=5,
        data_dir=str(tmp_path_factory.mktemp("odo")), device="cpu"))
    gs.run_streaming(N - 1)
    gs.drain_pending_loop_closures()
    info_odo = 1.0 / (0.03**2)
    odo_edges = [e for e in gs.opt.graph.edges
                 if abs(e.information[0, 0] - info_odo) < 1e-6]
    assert len(odo_edges) >= len(gs.keyframes) - 1
    # the edges differ between keyframes: odo_this advanced
    if len(odo_edges) >= 2:
        assert not np.allclose(odo_edges[0].T, odo_edges[1].T)


def test_streaming_handles_blackout(tmp_path_factory):
    """Frames the tracker cannot register (blackout) trigger the
    per-frame lost_recovery replay mid-chunk."""
    root = str(tmp_path_factory.mktemp("blackout"))
    traj = synthetic.orbit_trajectory(12, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR, write_pcd=False)
    # black out frames 5-7 (init takes frame 1)
    for i in (5, 6, 7):
        img_io.save_gray(os.path.join(root, "rgb_index", f"{i}.png"),
                         np.zeros((240, 320), np.uint8))

    gs = _start(tstream.StreamingGraphicEnd2(
        _params(root, lost_frames=1), chunk=4, data_dir=str(tmp_path_factory.mktemp("d")),
        device="cpu"))
    assert gs.run_streaming(11) == 11
    assert "9999" in _log_rows(gs)  # the blackout frames went lost
    assert gs.lost <= 1  # recovered after the blackout
    assert os.path.exists(os.path.join(gs.data_dir, "lost.txt"))  # lostRecovery fired


def test_streaming_chunk1_fused_per_frame(dataset, tmp_path_factory):
    """chunk=1 is the per-frame mode with one dispatch and one packed
    readback per frame, the next frame dispatched while this one's
    records apply."""
    root, traj = dataset
    gs = _start(tstream.StreamingGraphicEnd2(
        _params(root), data_dir=str(tmp_path_factory.mktemp("stream1")), chunk=1,
        device="cpu"))
    assert gs.run_streaming(N - 1) == N - 1
    gs.save_final_result()
    assert _ate(gs, traj) < 0.05
    assert len(_log_rows(gs)) == N - 1


def test_streaming_rescue_host_mirror(dataset, tmp_path_factory):
    """_process_chunk applies a rescued record as _rescue_with_last does:
    promote last then present, edges inverse(rr_T) / inverse(r_T), robot
    untouched, lost reset. The tracker writes the port's keyframe->last
    registration (the carried one) into rr_T, so inverse(rr_T) is the
    port's edge."""
    root, _ = dataset
    gs = _start(tstream.StreamingGraphicEnd2(
        _params(root), chunk=3, data_dir=str(tmp_path_factory.mktemp("rm")), device="cpu"))
    gs._ensure_tracker()

    st = gs._dispatch_chunk([2, 3, 4])
    recs = st["recs"].numpy().copy()
    # frame 3 (j=1) rescued, with known r_T and rr_T
    r_T = np.eye(4)
    r_T[0, 3] = 0.25
    rr_T = np.eye(4)
    rr_T[1, 3] = -0.5
    recs[1, 18] = 0.0  # ok = False
    recs[1, 19] = 0.0
    recs[1, 24] = 1.0  # rescued
    recs[1, 25:41] = r_T.reshape(16)
    recs[1, 43:59] = rr_T.reshape(16)
    recs[1, 20] = 0.0
    st["recs"] = torch.from_numpy(recs)

    kf_before = len(gs.keyframes)
    applied, clean = gs._process_chunk(st)
    assert applied == 3 and clean
    resc_kfs = [k for k in gs.keyframes[kf_before:] if k.frame_index in (2, 3)]
    k_last = next(k for k in resc_kfs if k.frame_index == 2)
    k_pres = next(k for k in resc_kfs if k.frame_index == 3)
    assert k_pres.id == k_last.id + 1
    edges = {(e.id1, e.id2): e.T for e in gs.opt.graph.edges}
    np.testing.assert_allclose(edges[(k_last.id - 1, k_last.id)], se3.inverse(rr_T), atol=1e-6)
    np.testing.assert_allclose(edges[(k_last.id, k_pres.id)], se3.inverse(r_T), atol=1e-6)
    assert gs.lost == 0


# -- the CLI -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["imageonly", "planes"])
def test_cli_run_slam_streaming_returns_0(dataset, tmp_path, monkeypatch, kind):
    root, _ = dataset
    with open(tmp_path / "parameters.yaml", "w") as f:
        for k, v in _overrides(root).items():
            f.write(f"{k}: {v}\n")
    monkeypatch.chdir(tmp_path)
    stats = {}
    assert run_slam_streaming.main(argv=["3", "2", kind], device="cpu", stats=stats) == 0
    for name in ("final.g2o", "final_after.g2o", "keyframe.txt", "error_of_transform.log"):
        assert (tmp_path / "data" / name).exists(), name
    ge = stats["graphic_end"]
    assert stats["frames"] == 3 and ge.image_only == (kind == "imageonly")
    assert ge.dispatches == 2 and stats["chunk_syncs"] == []  # nothing is watched on the CPU


def test_cli_run_slam_streaming_needs_a_card_unless_asked(dataset, tmp_path, monkeypatch):
    root, _ = dataset
    with open(tmp_path / "parameters.yaml", "w") as f:
        for k, v in _overrides(root).items():
            f.write(f"{k}: {v}\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_slam_streaming.main(argv=["2"])
