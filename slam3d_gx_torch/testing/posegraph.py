"""Synthetic large-scale pose-graph generator (counterpart of
slam3d_gx_tpu/testing/posegraph.py, on the port's optimizer).

The reference's vertex-ID scheme architecturally caps runs at 10,000
frames (reference src/const.h:25) but its largest attested run is 117
keyframes (reference data/keyframe.txt). This generator produces
ground-truthed multi-loop graphs at the 2k-10k-vertex regime so the
backend can be driven where the reference only promises to go:
a multi-revolution orbit (so the trajectory genuinely revisits places),
odometry edges integrated with drift, spatially-gated loop closures,
and optionally a fraction of outlier loops to exercise the robust
kernel — the structure of a long GraphicEnd run, at scale.
"""

from __future__ import annotations

import numpy as np

from ..geometry import se3


def make_loopy_graph(n_vertices: int, seed: int = 0,
                     revolutions: float = 6.0,
                     loop_density: float = 0.25,
                     odo_sigma_t: float = 0.01,
                     odo_sigma_r: float = 0.004,
                     loop_sigma_t: float = 0.002,
                     loop_sigma_r: float = 0.001,
                     outlier_frac: float = 0.0,
                     radius: float = 5.0, device=None):
    """Returns (optimizer, gt_poses, n_loops); the optimizer runs on
    `device` (the card unless "cpu" is asked for).

    Ground truth: an orbit of `revolutions` turns with slow vertical
    drift (vertices from different revolutions pass close by). Vertex
    estimates integrate odometry measurements corrupted by Gaussian
    noise (realistic accumulated drift); edges:
    - odometry: gt relative + noise, info = diag(100) like the
      frontend's visual edges (src/GraphicEnd.cpp:330-334);
    - loops: gt relative + small noise between spatially-near vertices
      at least 50 steps apart, Cauchy-robustified like loopClosure's
      edges (src/GraphicEnd.cpp:746-760); `loop_density` scales how
      many are drawn (fraction of n_vertices);
    - outliers: `outlier_frac` of the loop edges get a grossly wrong
      measurement (tests the robust kernel at scale).
    """
    from ..backend.pose_graph import PoseGraphOptimizer

    rng = np.random.default_rng(seed)
    n = n_vertices

    # ground-truth orbit
    theta = np.linspace(0.0, 2 * np.pi * revolutions, n)
    z = np.linspace(0.0, 0.5, n)
    gt = []
    for i in range(n):
        c, s = np.cos(theta[i]), np.sin(theta[i])
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t = np.array([radius * c, z[i], radius * s])
        gt.append(se3.make_isometry(R, t))

    def noisy(T_rel, st, sr):
        N = se3.make_isometry(
            se3.rodrigues(rng.normal(0, sr, 3)), rng.normal(0, st, 3))
        return T_rel @ N

    opt = PoseGraphOptimizer(device=device)
    info = np.eye(6) * 100.0
    opt.add_vertex(0, gt[0], fixed=True)
    est = gt[0]
    for i in range(1, n):
        Z = noisy(se3.inverse(gt[i - 1]) @ gt[i], odo_sigma_t, odo_sigma_r)
        est = est @ Z  # integrated drifted estimate
        opt.add_vertex(i, est)
        opt.add_edge(i - 1, i, Z, info)

    # spatially-gated loop closures between different revolutions
    pos = np.stack([T[:3, 3] for T in gt])
    per_rev = max(1, int(n / revolutions))
    n_loops_target = int(loop_density * n)
    loops = []
    tries = 0
    while len(loops) < n_loops_target and tries < 20 * n_loops_target:
        tries += 1
        a = int(rng.integers(0, n))
        b = a + per_rev * int(rng.integers(1, max(2, int(revolutions))))
        b += int(rng.integers(-per_rev // 8, per_rev // 8 + 1))
        if not (0 <= b < n) or abs(b - a) < 50:
            continue
        if np.linalg.norm(pos[a] - pos[b]) > 0.8:
            continue
        loops.append((a, b))
    n_out = int(len(loops) * outlier_frac)
    for k, (a, b) in enumerate(loops):
        if k < n_out:
            Z = se3.make_isometry(
                se3.rodrigues(rng.normal(0, 0.5, 3)),
                rng.normal(0, 2.0, 3))
        else:
            Z = noisy(se3.inverse(gt[a]) @ gt[b],
                      loop_sigma_t, loop_sigma_r)
        opt.add_edge(a, b, Z, info, robust=True)
    return opt, gt, len(loops)


def graph_ate(opt, gt) -> float:
    """RMSE of vertex translation error vs ground truth (no alignment:
    vertex 0 is fixed to gt, matching the SLAM convention)."""
    errs = [np.linalg.norm(opt.vertex_estimate(i)[:3, 3] - gt[i][:3, 3])
            for i in range(len(gt))]
    return float(np.sqrt(np.mean(np.square(errs))))
