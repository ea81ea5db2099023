"""The batched loop-closure verifier (parallel/registration.py) and its
wiring into both frontends, on the CPU.

- FeatureStore: add, gather, growth past its capacity;
- every row of the batched multiPnP (plane and image) equals the
  single-pair call on the same draws: `ok` and the inlier count exact, T
  within 1e-5 (a batched matrix product may block its sums differently
  from the single one);
- both verifiers against the JAX `build_batched_multipnp`
  (parallel/registration.py:58), jitted under `jitted_reference()`
  (tests/test_torch_jaxref.py), with the reference's draws
  (`jax.random.split(key, B)`): `ok` and inliers exact, T within 1e-4
  (fp32 Gauss-Newton on each side). The image verifier on 2 pairs, 32
  keypoints, 16 hypotheses; the plane verifier, which the reference
  always builds "tiered", on 4 pairs (three exact, one of unrelated
  frames that both reject); and the registrars' round over the store
  (`dispatch_against_one`), where the JAX one pads each chunk to 32
  rows by repeating keyframe 0 and splits its key once more per chunk,
  the port gathers only the real rows: the real rows agree;
- `resolve_async` keeps launch order and honours `n_valid`;
- both frontends finish a short orbit with `loop_closure_batched` 1 and
  0: the file set, and ATE below 0.06 m (the bound of
  tests/test_torch_slam.py); with 1 the registrar's own counter shows it
  verified the rounds, with 0 there is none.
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
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.config import ParameterReader
from slam3d_gx_torch.frontend import GraphicEnd, GraphicEnd2
from slam3d_gx_torch.frontend import pipeline as tpipe
from slam3d_gx_torch.frontend.state import FrameFeatures, result_to_host
from slam3d_gx_torch.parallel import registration as treg
from slam3d_gx_torch.testing import synthetic
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.parallel import registration as jreg
from test_torch_jaxref import KeyReplay, jitted  # noqa: F401  (a fixture)

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
TINTR = TorchIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
K, HYP = 32, 32


def jax_pair(seed, p):
    """An exact frame pair with integer descriptors (see
    tests/test_torch_multipnp.py)."""
    fa, fb = __graft_entry__._plane_frame_pair(INTR, np.random.default_rng(seed), p=p, k=K)
    return (fa._replace(desc=jnp.round(jnp.abs(fa.desc))),
            fb._replace(desc=jnp.round(jnp.abs(fb.desc))))


def to_port(f):
    return interop.features_from_numpy([np.asarray(a) for a in f], "cpu")


def port_pairs(p, seeds=(0, 1, 2)):
    """Exact pairs, plus one of unrelated frames that must be rejected."""
    pairs = [tuple(to_port(f) for f in jax_pair(s, p)) for s in seeds]
    pairs.append((pairs[0][0], pairs[1][1]))
    return pairs


def test_feature_store_add_gather_and_growth():
    rng = np.random.default_rng(0)

    def frame(i):
        return FrameFeatures(
            coeffs=torch.full((1, 4), float(i)), plane_valid=torch.ones(1, dtype=torch.bool),
            uv=torch.from_numpy(rng.random((1, 5, 2)).astype(np.float32)),
            kp3d=torch.full((1, 5, 3), float(i)), desc=torch.full((1, 5, 8), float(i)),
            kp_valid=torch.tensor([[True, False, True, True, i % 2 == 0]]))

    frames = [frame(i) for i in range(7)]
    store = treg.FeatureStore(frames[0], capacity=2, chunk=4)
    assert [store.add(f) for f in frames] == list(range(7))
    assert store.count == 7 and store.capacity == 8  # doubled twice
    got = store.gather([6, 0, 3])
    for name in FrameFeatures._fields:
        want = torch.stack([getattr(frames[i], name) for i in (6, 0, 3)])
        assert getattr(got, name).dtype == want.dtype
        torch.testing.assert_close(getattr(got, name), want, rtol=0, atol=0)
    assert store.gather([]).uv.shape == (0, 1, 5, 2)
    with pytest.raises(IndexError):
        store.gather([7])
    b = store.broadcast(frames[2], 3)
    assert b.desc.shape == (3, 1, 5, 8) and bool((b.desc == 2.0).all())
    stacked = treg.stack_features(frames[:3])
    torch.testing.assert_close(stacked.kp3d, store.gather([0, 1, 2]).kp3d, rtol=0, atol=0)


@pytest.mark.parametrize("image_only", [False, True], ids=["planes", "image"])
def test_batched_rows_equal_the_single_call(image_only):
    p = 1 if image_only else 3
    pairs = port_pairs(p)
    build = tpipe.build_multipnp_image if image_only else tpipe.build_multipnp_planes
    single = build(TINTR)
    batched = treg.build_batched_multipnp(TINTR, image_only=image_only)
    shape = (HYP, 3) if image_only else (p + 2, HYP, 3)
    u = torch.rand((len(pairs),) + shape, generator=torch.Generator().manual_seed(1))
    res = batched(treg.stack_features([a for a, _ in pairs]),
                  treg.stack_features([b for _, b in pairs]), u, 12)
    assert res.T.shape == (len(pairs), 4, 4) and res.ok.shape == (len(pairs),)
    oks = []
    for i, (fa, fb) in enumerate(pairs):
        T, norm, inl, ok = result_to_host(single(fa, fb, u[i], 12))
        assert bool(res.ok[i]) == ok and int(res.inliers[i]) == inl
        assert float(res.norm[i]) == pytest.approx(norm, abs=1e-5)
        np.testing.assert_allclose(res.T[i].numpy(), T, atol=1e-5)
        oks.append(ok)
    assert oks == [True, True, True, False]
    with pytest.raises(ValueError, match="batch axis"):
        batched(pairs[0][0], pairs[0][1], u[0], 12)


def test_batched_image_verifier_matches_jax(jitted):
    jpairs = [jax_pair(s, 1) for s in (0, 1)]
    hyp = 16
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, len(jpairs))
    fn = jreg.build_batched_multipnp(INTR, image_only=True, hypotheses=hyp)
    ref = fn(jreg.stack_features([a for a, _ in jpairs]),
             jreg.stack_features([b for _, b in jpairs]), keys, jnp.int32(12))
    ref = [np.asarray(x) for x in ref]
    u = interop.pnp_uniforms_batch(
        [np.asarray(jax.random.uniform(k, (hyp, 3))) for k in keys], "cpu")
    fa = interop.stacked_features_from_numpy(
        [[np.asarray(x) for x in a] for a, _ in jpairs], "cpu")
    fb = interop.stacked_features_from_numpy(
        [[np.asarray(x) for x in b] for _, b in jpairs], "cpu")
    res = treg.build_batched_multipnp(TINTR, image_only=True)(fa, fb, u, 12)
    ref_T, ref_norm, ref_inl, ref_ok = ref
    assert ref_ok.all()
    np.testing.assert_array_equal(res.ok.numpy(), ref_ok)
    np.testing.assert_array_equal(res.inliers.numpy(), ref_inl)
    np.testing.assert_allclose(res.norm.numpy(), ref_norm, atol=1e-4)
    np.testing.assert_allclose(res.T.numpy(), ref_T, atol=1e-4)


def _jax_plane_pairs():
    """Three exact plane pairs and one of unrelated frames."""
    pairs = [jax_pair(s, 3) for s in (0, 1, 2)]
    return pairs + [(pairs[0][0], pairs[1][1])]


def test_batched_plane_verifier_matches_jax(jitted):
    jpairs = _jax_plane_pairs()
    key = jax.random.PRNGKey(6)
    keys = jax.random.split(key, len(jpairs))
    ref = jreg.build_batched_multipnp(INTR, hypotheses=HYP)(
        jreg.stack_features([a for a, _ in jpairs]),
        jreg.stack_features([b for _, b in jpairs]), keys, jnp.int32(12))
    ref_T, ref_norm, ref_inl, ref_ok = (np.asarray(x) for x in ref)
    rep = KeyReplay(0, HYP, planes=3)
    u = interop.pnp_uniforms_batch([rep.pair_uniforms(k) for k in keys], "cpu")
    fa = interop.stacked_features_from_numpy([[np.asarray(x) for x in a] for a, _ in jpairs],
                                             "cpu")
    fb = interop.stacked_features_from_numpy([[np.asarray(x) for x in b] for _, b in jpairs],
                                             "cpu")
    res = treg.build_batched_multipnp(TINTR)(fa, fb, u, 12)
    assert ref_ok.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(res.ok.numpy(), ref_ok)
    np.testing.assert_array_equal(res.inliers.numpy(), ref_inl)
    np.testing.assert_allclose(res.norm.numpy(), ref_norm, atol=1e-4)
    np.testing.assert_allclose(res.T.numpy(), ref_T, atol=1e-4)


def test_plane_registrar_round_matches_jax(jitted):
    """A loop-closure round over the keyframe store: the JAX registrar
    pads the chunk to 32 rows with keyframe 0, the port's does not."""
    jpairs = _jax_plane_pairs()
    frames = [a for a, _ in jpairs[:3]]
    target = jpairs[1][1]  # the partner of stored frame 1 only
    cand = [1, 0, 2, 1]
    key = jax.random.PRNGKey(8)
    jstore = jreg.FeatureStore(frames[0])
    for f in frames:
        jstore.add(f)
    ref = jreg.BatchedRegistrar(INTR, image_only=False, hypotheses=HYP).run_against_one(
        jstore, cand, target, key, 12)
    tstore = treg.FeatureStore(to_port(frames[0]))
    for f in frames:
        tstore.add(to_port(f))
    out = treg.BatchedRegistrar(TINTR, image_only=False).run_against_one(
        tstore, cand, to_port(target), KeyReplay(0, HYP, planes=3).round_uniforms(key, len(cand)),
        12)
    assert [r[3] for r in ref] == [True, False, False, True]
    for (T, norm, inl, ok), (rT, rnorm, rinl, rok) in zip(out, ref):
        assert (ok, inl) == (bool(rok), int(rinl))
        assert norm == pytest.approx(float(rnorm), abs=1e-4)
        np.testing.assert_allclose(T, np.asarray(rT), atol=1e-4)


def test_registrar_chunks_keep_order_and_n_valid():
    pairs = port_pairs(1)
    reg = treg.BatchedRegistrar(TINTR, image_only=True)
    store = treg.FeatureStore(pairs[0][0], capacity=2, chunk=2)
    for fa, _ in pairs:
        store.add(fa)
    target = pairs[1][1]  # the partner of stored frame 1 only
    u = torch.rand((4, HYP, 3), generator=torch.Generator().manual_seed(2))
    pending = reg.dispatch_against_one(store, [1, 0, 2, 1], target, u, 12)
    assert [n for _, n in pending] == [2, 2] and reg.calls == 2 and reg.pairs == 4
    assert all(packed.shape == (2, 19) for packed, _ in pending)
    out = treg.resolve_async(pending)
    assert [r[3] for r in out] == [True, False, False, True]
    # the same candidate on the same draws gives the same row, wherever it sits
    again = reg.run_against_one(store, [1], target, u[:1], 12)
    np.testing.assert_allclose(again[0][0], out[0][0], atol=1e-5)
    # n_valid cuts a caller's padding rows off
    fa, fb = store.gather([1, 0]), store.broadcast(target, 2)
    assert len(reg.run_stacked(fa, fb, u[:2], 12, n_valid=1)) == 1
    # the flipped direction registers target -> store[i]: the inverse
    # motion (both frames carry exact 3-D points; two RANSAC fits, so 5e-3)
    flipped = reg.run_against_one(store, [1], target, u[:1], 12, single_is_target=False)
    assert flipped[0][3]
    np.testing.assert_allclose(flipped[0][0] @ out[0][0], np.eye(4), atol=5e-3)
    assert not np.allclose(out[0][0], np.eye(4), atol=5e-3)
    # the call form over explicit pairs, chunked
    called = reg(pairs, u, 12, chunk=3)
    assert [r[3] for r in called] == [True, True, True, False]
    with pytest.raises(ValueError, match="rows of uniforms"):
        reg(pairs, u[:2], 12)
    assert treg.resolve_async([]) == []


N_FRAMES = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("room"))
    traj = synthetic.orbit_trajectory(30, radius=0.25, yaw_amp=0.15)[:N_FRAMES]
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, TINTR, write_pcd=True)
    return root, traj


@pytest.mark.parametrize("batched", [1, 0])
@pytest.mark.parametrize("frontend", [GraphicEnd, GraphicEnd2])
def test_frontends_finish_with_either_verifier(dataset, tmp_path, frontend, batched):
    root, traj = dataset
    over = dict(data_source=root, detector_name="GFTT", descriptor_name="SIFT",
                camera_fx=TINTR.fx, camera_fy=TINTR.fy, camera_cx=TINTR.cx,
                camera_cy=TINTR.cy, camera_factor=TINTR.factor, max_keypoints=128,
                ransac_hypotheses=64, frame_kp_budget=384, max_pos_change=0.03,
                loopclosure_frames=4, end_index=100, loop_closure_batched=batched)
    datadir = str(tmp_path)
    ge = frontend(ParameterReader(None, overrides=over), data_dir=datadir, device="cpu")
    ge.lc_drain_threshold = 2  # so that a drain happens inside the run too
    slam = SLAMEnd(device="cpu")
    ge.init(slam)
    slam.init(ge)
    for _ in range(N_FRAMES - 1):
        ge.run()
    slam.globalOptimizer.save(os.path.join(datadir, "final.g2o"))
    ge.save_final_result()
    assert not ge._pending_lc
    for name in ("final.g2o", "final_after.g2o", "keyframe.txt", "error_of_transform.log"):
        assert os.path.getsize(os.path.join(datadir, name)) > 0, name
    assert len(ge.keyframes) >= 5
    est = [ge.opt.vertex_estimate(kf.id) for kf in ge.keyframes]
    gt = [traj[kf.frame_index - 1] for kf in ge.keyframes]
    ate = synthetic.ate_rmse(gt, est)
    assert ate < 0.06, f"ATE {ate}"
    n_edges = len(ge.opt.graph.edges)
    assert n_edges > len(ge.keyframes) - 1, "no loop edge was added"
    if batched:
        # one batched call per loop-closure round (keyframes 4 on) and
        # per findMoreLoops source, each over more than one pair
        assert ge.kf_store.count == len(ge.keyframes)
        assert ge.batch_registrar.calls >= len(ge.keyframes) - 3
        assert ge.batch_registrar.pairs > ge.batch_registrar.calls
    else:
        assert ge.batch_registrar is None and ge.kf_store is None
