"""The port's whole image-only application under a mesh, on gloo ranks on
the CPU (counterpart of tests/test_mesh_e2e.py, same dataset and
parameters).

GraphicEnd2, 12 frames of the synthetic room orbit, with
`mesh_devices: 0` in this process against 2 gloo ranks with
`mesh_devices: 2` (spawned by slam3d_gx_torch.testing.ranks, file://
rendezvous in tmp_path), each rank with its own data directory:

- the keyframes' frame indices and the loop edges are equal: every rank
  draws the whole batch's PnP uniforms before it takes its rows, so the
  draws are the run's own;
- final poses within 1e-4 m of the unsharded run (the sharded pose-graph
  solve sums in another order), ATE < 0.05 m;
- only rank 0 wrote files;
- the streamed frontend and the scored database under the mesh
  (tests/test_mesh_e2e.py:113-148): their loop rounds go through the
  dp-split verifier and the sp-split database, ATE < 0.05 m.
"""

import os

import numpy as np
import pytest

from slam3d_gx_torch.backend import SLAMEnd
from slam3d_gx_torch.config import CameraIntrinsics, ParameterReader
from slam3d_gx_torch.frontend import GraphicEnd2
from slam3d_gx_torch.frontend.streaming import StreamingGraphicEnd2
from slam3d_gx_torch.testing import ranks, synthetic

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N_FRAMES = 12
ATE_BOUND = 0.05
POSE_TOL = 1e-4
OUTPUTS = {"final_after.g2o", "keyframe.txt", "error_of_transform.log"}


def make_params(root, **kw):
    over = dict(
        data_source=root, detector_name="GFTT", descriptor_name="SIFT",
        camera_fx=INTR.fx, camera_fy=INTR.fy, camera_cx=INTR.cx,
        camera_cy=INTR.cy, camera_factor=INTR.factor,
        max_keypoints=256, ransac_hypotheses=128,
        max_pos_change=0.05, end_index=100, grid_leaf=0.05,
    )
    over.update(kw)
    return ParameterReader(None, overrides=over)


def run_slam(root, data_dir, streamed=False, **kw):
    """One run to its saved result; returns what the tests read of it."""
    params = make_params(root, **kw)
    if streamed:
        ge = StreamingGraphicEnd2(params, data_dir=data_dir, chunk=4, device="cpu")
    else:
        ge = GraphicEnd2(params, data_dir=data_dir, device="cpu")
    slam = SLAMEnd(device="cpu")
    ge.init(slam)
    slam.init(ge)
    if streamed:
        assert ge.run_streaming(N_FRAMES - 1) == N_FRAMES - 1
        ge.drain_pending_loop_closures()
    else:
        for _ in range(N_FRAMES - 1):
            ge.run()
    ge.save_final_result()
    return dict(
        frames=[kf.frame_index for kf in ge.keyframes],
        loops=[(e.id1, e.id2) for e in ge.opt.graph.edges if e.robust],
        poses=np.stack([ge.opt.vertex_estimate(kf.id) for kf in ge.keyframes]),
        files=sorted(os.listdir(data_dir)) if os.path.isdir(data_dir) else [],
        mesh=None if ge.mesh is None else tuple(ge.mesh.shape),
        dp=ge.batch_registrar.dp,
        db_sp=None if ge.lcdb is None else ge.lcdb.sp,
        db_meshed=ge.lcdb is not None and ge.lcdb.mesh is ge.mesh,
        fused=ge.batch_registrar.fused)


def rank_worker(rank: int, world: int, root: str, base: str) -> dict:
    runs = {}
    for name, kw in (("plain", {}), ("streamed", {"streamed": True}),
                     ("scored", {"loop_closure_scored": 1})):
        runs[name] = run_slam(root, os.path.join(base, f"{name}_rank{rank}"),
                              mesh_devices=world, **kw)
    return runs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_room"))
    traj = synthetic.orbit_trajectory(N_FRAMES, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR, write_pcd=False)
    return root, traj


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    root, _ = dataset
    base = str(tmp_path_factory.mktemp("mesh_runs"))
    single = run_slam(root, os.path.join(base, "single"), mesh_devices=0)
    meshed = ranks.run(rank_worker, 2, os.path.join(base, "ranks"), root, base)
    return single, meshed


def ate(run, traj):
    return synthetic.ate_rmse([traj[f - 1] for f in run["frames"]], list(run["poses"]))


def test_mesh_run_equals_the_single_device_run(dataset, runs):
    _, traj = dataset
    single, meshed = runs
    assert single["mesh"] is None and single["dp"] == 1
    assert len(single["frames"]) >= 5 and single["loops"]
    for out in meshed:
        run = out["plain"]
        assert run["mesh"] == (2, 1) and run["dp"] == 2
        assert run["frames"] == single["frames"]
        assert run["loops"] == single["loops"]
        np.testing.assert_allclose(run["poses"][:, :3, 3], single["poses"][:, :3, 3],
                                   atol=POSE_TOL)
        assert ate(run, traj) < ATE_BOUND


def test_only_rank_0_writes(runs):
    single, meshed = runs
    assert OUTPUTS <= set(single["files"])
    assert meshed[0]["plain"]["files"] == single["files"]
    for name in ("plain", "streamed", "scored"):
        assert OUTPUTS <= set(meshed[0][name]["files"])
        assert meshed[1][name]["files"] == []


def test_mesh_streaming(dataset, runs):
    _, traj = dataset
    for out in runs[1]:
        run = out["streamed"]
        assert run["mesh"] == (2, 1) and run["dp"] == 2
        assert len(run["frames"]) >= 5
        assert ate(run, traj) < ATE_BOUND
    assert runs[1][0]["streamed"]["frames"] == runs[1][1]["streamed"]["frames"]


def test_mesh_scored_database(dataset, runs):
    _, traj = dataset
    for out in runs[1]:
        run = out["scored"]
        assert run["db_meshed"] and run["db_sp"] == 1 and run["fused"] > 0
        assert len(run["frames"]) >= 5
        assert ate(run, traj) < ATE_BOUND
    assert runs[1][0]["scored"]["loops"] == runs[1][1]["scored"]["loops"]
