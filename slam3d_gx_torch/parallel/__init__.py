"""Batched and multi-device work over independent pairs, keyframes and
edges (counterpart of slam3d_gx_tpu/parallel):

- mesh.py        : process groups (one rank a card) and the (dp, sp)
                   DeviceMesh;
- registration.py: batched pairwise registration, split over dp;
- lcdb.py        : the keyframe retrieval database, rows split over sp.

The pose graph's multi-device path lives with the solver
(backend/pose_graph.py): `PoseGraphOptimizer.optimize(mesh=...)` splits
the edges over dp and all-reduces the normal equations (dense) or each
matvec (CG). `optimize_sharded` below is the convenience entry point.
"""

from typing import Optional


def optimize_sharded(opt, device_mesh, n_iters: int = 200,
                     solver: Optional[str] = None) -> float:
    """Run a PoseGraphOptimizer's LM loop with its edges split over the
    mesh's dp axis; every rank calls this on the same graph."""
    return opt.optimize(n_iters=n_iters, solver=solver, mesh=device_mesh)
