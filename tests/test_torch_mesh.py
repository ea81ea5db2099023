"""The port's multi-device layer (parallel/mesh.py, the mesh paths of
parallel/registration.py, parallel/lcdb.py and backend/pose_graph.py) on
gloo ranks on the CPU, at world sizes 2 (dp 2, sp 1) and 4 (dp 2, sp 2).

Ranks are spawned with torch.multiprocessing and join through a file://
rendezvous in tmp_path (slam3d_gx_torch.testing.ranks). Every rank makes
the same inputs from a seed with numpy and returns what it computed; the
parent holds it to the unsharded port and, for the pose graph, to the
JAX package's `optimize_sharded` on the conftest's 8-device CPU mesh:

- make_mesh: shapes and the row-major rank layout of JAX's
  `devices.reshape((dp, sp))` (counterpart of tests/test_parallel.py:23);
- registrar rows bit-equal to unsharded, image and plane pairs, B = 7 so
  that the batch is padded (tests/test_parallel.py:70-110, :373);
- database scores exactly equal across a grow from capacity 8 to 16, and
  select_candidates_device and top_candidates equal (:179, :249, :275);
- pose graph, dense and CG, on a 12-vertex ring with 13 edges (not a
  multiple of dp): poses within 1e-4 m of the unsharded port and within
  5e-3 m of JAX's sharded solve, chi2 <= 1.5 chi2_JAX + 1e-3 (JAX's own
  bounds, :218-246);
- `mesh_devices: N` with no process group, or N other than the world
  size, raises naming torchrun.

Module-level imports are torch-only: the spawned ranks import this
module to find their worker, and JAX is imported where it is compared.
"""

import numpy as np
import pytest
import torch

from slam3d_gx_torch.backend.pose_graph import PoseGraphOptimizer
from slam3d_gx_torch.config import CameraIntrinsics, ParameterReader
from slam3d_gx_torch.frontend import GraphicEnd2
from slam3d_gx_torch.frontend.state import FrameFeatures
from slam3d_gx_torch.geometry import se3
from slam3d_gx_torch.parallel import lcdb, mesh as mesh_mod, optimize_sharded, registration
from slam3d_gx_torch.testing import ranks

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
B, K, D, HYP = 7, 32, 32, 32
POSE_TOL = 1e-4   # m, sharded port against unsharded port
JAX_TOL = 5e-3    # m, sharded port against JAX optimize_sharded
WORLDS = (2, 4)


# -- inputs, the same on every rank --------------------------------------
def _pair(seed: int, p: int):
    """An exact P-plane frame pair with integer descriptors (the shape of
    __graft_entry__._plane_frame_pair at small sizes), numpy arrays."""
    rng = np.random.default_rng(seed)
    R = se3.rodrigues(np.array([0.0, np.deg2rad(3.0), 0.0]))
    tv = np.array([0.05, 0.0, 0.01])
    normals = np.array([[0.0, 0.0, -1.0], [-0.95, 0.0, -0.31], [0.0, -0.95, -0.31]])[:p]
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    ds = np.array([3.0, 2.5, 2.2])[:p]
    frames = {"a": [], "b": []}
    for i in range(p):
        n, d0 = normals[i], ds[i]
        e1 = np.cross(n, [0.0, 1.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        pts = -d0 * n + rng.uniform(-0.8, 0.8, (K, 1)) * e1 + rng.uniform(-0.8, 0.8, (K, 1)) * e2
        nb = R @ n
        for side, P3, c in (("a", pts, np.r_[n, d0]),
                            ("b", pts @ R.T + tv, np.r_[nb, d0 - nb @ tv])):
            uv = np.stack([INTR.fx * P3[:, 0] / np.maximum(P3[:, 2], 0.3) + INTR.cx,
                           INTR.fy * P3[:, 1] / np.maximum(P3[:, 2], 0.3) + INTR.cy], 1)
            frames[side].append((c if c[3] >= 0 else -c, uv, P3))
    desc = np.round(np.abs(rng.normal(size=(p, K, D)) * 10)).astype(np.float32)

    def feats(rows):
        return FrameFeatures(
            coeffs=torch.tensor(np.stack([r[0] for r in rows]), dtype=torch.float32),
            plane_valid=torch.ones(p, dtype=torch.bool),
            uv=torch.tensor(np.stack([r[1] for r in rows]), dtype=torch.float32),
            kp3d=torch.tensor(np.stack([r[2] for r in rows]), dtype=torch.float32),
            desc=torch.from_numpy(desc), kp_valid=torch.ones((p, K), dtype=torch.bool))

    return feats(frames["a"]), feats(frames["b"])


def _registration_inputs(image_only: bool):
    """B pairs: exact ones and, every third, unrelated frames that fail;
    one row of uniforms a pair."""
    p = 1 if image_only else 3
    exact = [_pair(s, p) for s in range(B)]
    pairs = [(a, exact[(i + 1) % B][1]) if i % 3 == 2 else (a, b)
             for i, (a, b) in enumerate(exact)]
    shape = (HYP, 3) if image_only else (p + 2, HYP, 3)
    u = torch.rand((B,) + shape, generator=torch.Generator().manual_seed(11))
    return pairs, u


def _registrations(image_only: bool, mesh):
    """The batched call and a fused round over a feature store, as host
    arrays: (rows of (T, norm, inliers, ok), (B, 21) fused rows)."""
    pairs, u = _registration_inputs(image_only)
    reg = registration.BatchedRegistrar(INTR, image_only=image_only, mesh=mesh)
    rows = reg(pairs, u, 12)
    store = registration.FeatureStore(pairs[0][0], capacity=4)
    for a, _ in pairs:
        store.add(a)
    idx = torch.tensor([6, 0, 3, 5, 1, 2, 4])
    fused = reg.dispatch_fused(store, idx, idx % 2 == 0, pairs[0][1], u, 12)
    return rows, fused.numpy()


def _frame(rng):
    return FrameFeatures(
        coeffs=torch.zeros((1, 4)), plane_valid=torch.ones(1, dtype=torch.bool),
        uv=torch.zeros((1, 96, 2)), kp3d=torch.zeros((1, 96, 3)),
        desc=torch.from_numpy((rng.normal(size=(1, 96, D)) * 10).astype(np.float32)),
        kp_valid=torch.from_numpy(rng.random((1, 96)) > 0.1))


def _database(mesh):
    """Scores of a query after 8 adds (full at capacity 8) and after 10
    (grown to 16), the device selection and the host top candidates."""
    rng = np.random.default_rng(13)
    frames = [_frame(rng) for _ in range(10)]
    q = frames[4]._replace(desc=frames[4].desc + 0.5)
    db = lcdb.KeyframeDatabase(n_desc=96, dim=D, capacity=8, device="cpu", mesh=mesh)
    for f in frames[:8]:
        db.add(f)
    before = db.scores(q)
    for f in frames[8:]:
        db.add(f)
    idx, valid = db.select_candidates_device(q, 4)
    over_idx, over_valid = db.select_candidates_device(q, 12)
    return dict(before=before, after=db.scores(q), capacity=db.capacity,
                select=(idx.numpy(), valid.numpy()),
                select_over=(over_idx.numpy(), over_valid.numpy()),
                top=db.top_candidates(q, 4), local_rows=db.desc.shape[0])


def ring_graph(n: int = 12, noise: float = 0.01):
    """tests/test_parallel.py's noisy ring plus a chord 0 -> n/2: n
    vertices, n + 1 edges. Returns (vertices [(T, fixed)], edges [(i, j,
    Z, info, robust)], ground truth)."""
    rng = np.random.default_rng(5)
    step = se3.make_isometry(se3.rodrigues(np.array([0, 2 * np.pi / n, 0.0])),
                             np.array([0.3, 0, 0.0]))
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    verts = [(gt[0], True)]
    for i in range(1, n):
        T = gt[i].copy()
        T[:3, 3] += rng.normal(0, noise, 3)
        verts.append((T, False))
    info = np.eye(6) * 100
    edges = []
    for i in range(1, n):
        Z = se3.inverse(gt[i - 1]) @ gt[i]
        Z[:3, 3] += rng.normal(0, noise, 3)
        edges.append((i - 1, i, Z, info, False))
    edges.append((n - 1, 0, se3.inverse(gt[n - 1]) @ gt[0], info, True))
    edges.append((0, n // 2, se3.inverse(gt[0]) @ gt[n // 2], info, True))
    return verts, edges, gt


def _fill(opt, graph):
    verts, edges, _ = graph
    for v, (T, fixed) in enumerate(verts):
        opt.add_vertex(v, T, fixed=fixed)
    for e in edges:
        opt.add_edge(*e)
    return opt


def _pose_graph(solver: str, mesh):
    """(chi2, (V, 3) translations) of 15 LM iterations on the ring."""
    opt = _fill(PoseGraphOptimizer(device="cpu"), ring_graph())
    if mesh is None:
        chi = opt.optimize(n_iters=15, solver=solver)
    else:
        chi = optimize_sharded(opt, mesh, n_iters=15, solver=solver)
    return chi, np.stack([opt.vertex_estimate(v)[:3, 3] for v in sorted(opt.graph.vertices)])


def _params(**kw):
    over = dict(data_source=".", detector_name="GFTT", descriptor_name="SIFT",
                camera_fx=INTR.fx, camera_fy=INTR.fy, camera_cx=INTR.cx, camera_cy=INTR.cy,
                camera_factor=INTR.factor, end_index=100)
    over.update(kw)
    return ParameterReader(None, overrides=over)


def _mesh_devices_error(n: int) -> str:
    try:
        GraphicEnd2(_params(mesh_devices=n), device="cpu")
    except ValueError as e:
        return str(e)
    return ""


# -- the ranks ---------------------------------------------------------------
def rank_worker(rank: int, world: int) -> dict:
    import torch.distributed as dist

    mesh = mesh_mod.make_mesh(world, device="cpu")
    out = dict(
        coordinate=mesh.get_coordinate(), shape=tuple(mesh.shape),
        dp_group=dist.get_process_group_ranks(mesh.get_group("dp")),
        sp_group=dist.get_process_group_ranks(mesh.get_group("sp")),
        mesh_devices_error=_mesh_devices_error(world + 1),
        registrar_dp=registration.BatchedRegistrar(INTR, True, mesh=mesh).dp)
    for image_only in (True, False):
        out[("registration", image_only)] = _registrations(image_only, mesh)
    out["database"] = _database(mesh)
    for solver in ("dense", "cg"):
        out[("pose_graph", solver)] = _pose_graph(solver, mesh)
    return out


_RESULTS = {}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """world -> the ranks' results (spawned once per world size)."""

    def get(world):
        if world not in _RESULTS:
            _RESULTS[world] = ranks.run(rank_worker, world,
                                        tmp_path_factory.mktemp(f"world{world}"))
        return _RESULTS[world]

    return get


# -- the tests -----------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_shapes_and_rank_layout(sharded, world):
    res = sharded(world)
    dp, sp = mesh_mod._factor_2d(world)
    grid = np.arange(world).reshape(dp, sp)
    for r, out in enumerate(res):
        assert out["shape"] == (dp, sp)
        i, j = out["coordinate"]
        assert grid[i, j] == r
        assert out["dp_group"] == grid[:, j].tolist()
        assert out["sp_group"] == grid[i].tolist()
        assert out["registrar_dp"] == dp
    assert (dp, sp) == {2: (2, 1), 4: (2, 2)}[world]
    assert mesh_mod._factor_2d(8) == (4, 2) and mesh_mod._factor_2d(1) == (1, 1)


@pytest.mark.parametrize("image_only", [True, False], ids=["image", "planes"])
@pytest.mark.parametrize("world", WORLDS)
def test_registrar_rows_bit_equal_to_unsharded(sharded, world, image_only):
    rows, fused = _registrations(image_only, None)
    assert [ok for *_, ok in rows].count(False) >= 2  # the unrelated pairs fail
    assert [ok for *_, ok in rows].count(True) >= 4
    for out in sharded(world):
        got_rows, got_fused = out[("registration", image_only)]
        assert len(got_rows) == B
        for (T, norm, inl, ok), (Tg, ng, ig, okg) in zip(rows, got_rows):
            np.testing.assert_array_equal(Tg, T)
            assert (ng, ig, okg) == (norm, inl, ok)
        assert got_fused.shape == (B, 21)
        np.testing.assert_array_equal(got_fused, fused)


@pytest.mark.parametrize("world", WORLDS)
def test_database_scores_exact_across_a_grow(sharded, world):
    ref = _database(None)
    assert ref["capacity"] == 16
    sp = mesh_mod._factor_2d(world)[1]
    for out in (o["database"] for o in sharded(world)):
        assert out["capacity"] == 16 and out["local_rows"] == 16 // sp
        np.testing.assert_array_equal(out["before"], ref["before"])
        np.testing.assert_array_equal(out["after"], ref["after"])
    assert int(np.argmax(ref["after"])) == 4


@pytest.mark.parametrize("world", WORLDS)
def test_database_selection_equal(sharded, world):
    ref = _database(None)
    assert ref["top"][0] == 4
    for out in (o["database"] for o in sharded(world)):
        for key in ("select", "select_over"):
            np.testing.assert_array_equal(out[key][0], ref[key][0])
            np.testing.assert_array_equal(out[key][1], ref[key][1])
        assert out["top"] == ref["top"]


def _jax_sharded(solver: str):
    """JAX's optimize_sharded on the conftest's 8-device CPU mesh, on the
    same ring: (chi2, (V, 3) translations)."""
    from slam3d_gx_tpu.backend.pose_graph import PoseGraphOptimizer as JaxOptimizer
    from slam3d_gx_tpu.parallel import mesh as jmesh, optimize_sharded as joptimize_sharded

    opt = _fill(JaxOptimizer(), ring_graph())
    chi = joptimize_sharded(opt, jmesh.make_mesh(8), n_iters=15, solver=solver)
    return chi, np.stack([opt.vertex_estimate(v)[:3, 3] for v in sorted(opt.graph.vertices)])


_JAX = {}


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("world", WORLDS)
def test_pose_graph_sharded(sharded, world, solver):
    chi_u, t_u = _pose_graph(solver, None)
    if solver not in _JAX:
        _JAX[solver] = _jax_sharded(solver)
    chi_j, t_j = _JAX[solver]
    gt = np.stack([T[:3, 3] for T in ring_graph()[2]])
    for out in sharded(world):
        chi, t = out[("pose_graph", solver)]
        np.testing.assert_allclose(t, t_u, atol=POSE_TOL)
        np.testing.assert_allclose(t, t_j, atol=JAX_TOL)
        assert chi <= 1.5 * chi_j + 1e-3, (chi, chi_j)
        assert np.abs(t - gt).max() < 0.05


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_devices_other_than_the_world_size_raises(sharded, world):
    for out in sharded(world):
        assert "torchrun" in out["mesh_devices_error"]


def test_mesh_without_a_group():
    """No process group: mesh_devices N > 1 raises naming torchrun, -1 and
    0 run without a mesh, and make_mesh(1) starts a one-rank group."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun"):
        mesh_mod.make_mesh(2, device="cpu")
    assert "torchrun" in _mesh_devices_error(2)
    for n in (0, -1):
        assert GraphicEnd2(_params(mesh_devices=n), device="cpu").mesh is None
    try:
        m = mesh_mod.make_mesh(1, device="cpu")
        assert tuple(m.shape) == (1, 1) and dist.get_world_size() == 1
        assert mesh_mod.axis_size(m, "dp") == 1 and mesh_mod.axis_rank(m, "sp") == 0
    finally:
        dist.destroy_process_group()
