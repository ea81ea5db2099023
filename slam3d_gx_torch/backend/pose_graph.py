"""Pose-graph backend: SE(3) Levenberg-Marquardt on tensors
(counterpart of slam3d_gx_tpu/backend/pose_graph.py).

The reference's g2o assembly (SLAMEnd: CSparse -> BlockSolver_6_3 ->
Levenberg + a robust kernel built by name, src/GraphicEnd.h:223-256) and
SparseOptimizer::optimize (src/GraphicEnd.cpp:669-670). Edges are
linearized as one batch (residual = se3_log(Zij^-1 Xi^-1 Xj), Jacobians
by forward-mode autodiff of local right perturbations), robust weights
applied per edge, and the damped normal equations solved densely as one
(6V,6V) system. Each LM iteration assembles the system once and the loop
stops early on a chi2 plateau, like g2o's terminate action. Fixed
vertices get identity rows (gauge fixing; vertex 0 is fixed by the
frontend).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import se3 as se3_np
from ..io import g2o_io
from ..ops import lie

# robust-kernel codes; an unknown name constructs no kernel, as g2o's
# factory does (src/GraphicEnd.h:245)
_KERNEL_NONE, _KERNEL_CAUCHY, _KERNEL_HUBER = 0, 1, 2
_KERNELS = {"cauchy": _KERNEL_CAUCHY, "huber": _KERNEL_HUBER}

# largest graph solved densely; the matrix-free CG solver above it is
# ROADMAP.md queue 1 item 11
_DENSE_VMAX = 512


def _edge_residual(Ti, Tj, Zinv):
    return lie.se3_log(Zinv @ lie.inv_T(Ti) @ Tj)


def _edge_jacobians(Ti, Tj, Zinv):
    """d residual / d (xi_i, xi_j) of one edge for Ti <- Ti exp(xi_i),
    Tj <- Tj exp(xi_j)."""

    def f(xi):
        return _edge_residual(Ti @ lie.se3_exp(xi[:6]), Tj @ lie.se3_exp(xi[6:]), Zinv)

    J = torch.func.jacfwd(f)(torch.zeros(12, dtype=Ti.dtype, device=Ti.device))
    return J[:, :6], J[:, 6:]


def _edge_terms(poses, e_i, e_j, e_Zinv, e_info, e_robust, kernel: int,
                delta: float):
    """Batched linearization of every edge -> (chi_total, Bii, Bjj, Bij,
    g_i, g_j): the robust-weighted (E,6,6) normal-equation blocks and
    (E,6) gradient contributions."""
    Ti, Tj = poses[e_i], poses[e_j]
    r = torch.func.vmap(_edge_residual)(Ti, Tj, e_Zinv)  # (E,6)
    Jii, Jjj = torch.func.vmap(_edge_jacobians)(Ti, Tj, e_Zinv)
    chi = torch.sum(r * (e_info @ r[..., None])[..., 0], dim=1)
    d2 = delta ** 2
    if kernel == _KERNEL_CAUCHY:
        wr = 1.0 / (1.0 + chi / d2)
        rho = d2 * torch.log1p(chi / d2)
    elif kernel == _KERNEL_HUBER:
        root = torch.sqrt(torch.clamp(chi, min=1e-12))
        wr = torch.where(chi <= d2, 1.0, delta / root)
        rho = torch.where(chi <= d2, chi, 2.0 * delta * root - d2)
    else:
        wr, rho = torch.ones_like(chi), chi
    w = torch.where(e_robust, wr, 1.0)
    info_w = e_info * w[:, None, None]

    def quad(A, B):
        return A.transpose(-1, -2) @ info_w @ B

    g_i = (Jii.transpose(-1, -2) @ info_w @ r[..., None])[..., 0]
    g_j = (Jjj.transpose(-1, -2) @ info_w @ r[..., None])[..., 0]
    # robust edges contribute rho(chi), plain edges chi (g2o's
    # activeRobustChi2)
    chi_total = torch.sum(torch.where(e_robust, rho, chi))
    return chi_total, quad(Jii, Jii), quad(Jjj, Jjj), quad(Jii, Jjj), g_i, g_j


def optimize_dense(poses, fixed, e_i, e_j, e_Zinv, e_info, e_robust,
                   n_iters: int, kernel: int, cauchy_delta: float = 1.0,
                   rel_tol: float = 1e-8):
    """LM with a dense (6V,6V) solve. poses (V,4,4) -> (poses, chi2, iters)."""
    V = poses.shape[0]
    free = ~fixed
    fmask = free.repeat_interleave(6)
    diag = torch.arange(6 * V, device=poses.device)

    def system(p):
        chi, Bii, Bjj, Bij, g_i, g_j = _edge_terms(
            p, e_i, e_j, e_Zinv, e_info, e_robust, kernel, cauchy_delta)
        H = torch.zeros((V, V, 6, 6), dtype=p.dtype, device=p.device)
        H.index_put_((e_i, e_i), Bii, accumulate=True)
        H.index_put_((e_j, e_j), Bjj, accumulate=True)
        H.index_put_((e_i, e_j), Bij, accumulate=True)
        H.index_put_((e_j, e_i), Bij.transpose(-1, -2), accumulate=True)
        g = torch.zeros((V, 6), dtype=p.dtype, device=p.device)
        g.index_add_(0, e_i, g_i)
        g.index_add_(0, e_j, g_j)
        return chi, H, g

    def solve(H, g, lam):
        Hd = H.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
        Hd = torch.where(fmask[:, None] & fmask[None, :], Hd, 0.0)
        Hd[diag, diag] += torch.where(fmask, lam * (torch.diagonal(Hd) + 1e-6), 1.0)
        gd = torch.where(fmask, g.reshape(-1), 0.0)
        return torch.linalg.solve_ex(Hd, -gd)[0].reshape(V, 6)

    def apply_delta(p, dx):
        return p @ lie.se3_exp(dx * free[:, None])

    chi, H, g = system(poses)
    lam = 1e-4
    it = 0
    while it < n_iters:
        cand = apply_delta(poses, solve(H, g, lam))
        chi_new, H_new, g_new = system(cand)
        better = bool(chi_new < chi)
        rel = float((chi - chi_new) / torch.clamp(chi, min=1e-12))
        it += 1
        if better:
            poses, chi, H, g = cand, chi_new, H_new, g_new
            if rel < rel_tol:
                break
            lam = max(lam * 0.5, 1e-8)
        else:
            if lam >= 1e6:
                break
            lam = min(lam * 4.0, 1e6)
    return poses, chi, it


class PoseGraphOptimizer:
    """Host wrapper: owns a g2o_io.Graph and runs the LM core on `device`.

    robust_kernel: kernel applied to edges added with robust=True (config
    key `robust_kernel`: "Cauchy" default, "Huber", anything else none).
    """

    def __init__(self, graph: Optional[g2o_io.Graph] = None,
                 robust_kernel: str = "Cauchy", device=None):
        self.graph = graph if graph is not None else g2o_io.Graph()
        self.robust_kernel = robust_kernel
        self.device = resolve_device(device)
        self.last_iters = 0  # LM iterations of the last optimize()

    # --- graph building (g2o SparseOptimizer surface analog) ----------
    def add_vertex(self, vid: int, T: np.ndarray, fixed: bool = False):
        self.graph.add_vertex(vid, T, fixed)

    def add_edge(self, id1: int, id2: int, T: np.ndarray, information: np.ndarray,
                 robust: bool = False):
        self.graph.add_edge(id1, id2, T, information, robust)

    def vertex_estimate(self, vid: int) -> np.ndarray:
        return self.graph.vertices[vid].T

    def save(self, path: str):
        g2o_io.save_g2o(self.graph, path)

    def load(self, path: str):
        self.graph = g2o_io.load_g2o(path)

    # --- optimization ---------------------------------------------------
    def optimize(self, n_iters: int = 200) -> float:
        """Run LM on the whole graph; returns the final robust chi2."""
        g = self.graph
        if not g.vertices or not g.edges:
            return 0.0
        ids = sorted(g.vertices)
        if len(ids) > _DENSE_VMAX:
            raise NotImplementedError(
                f"{len(ids)} vertices: the CG pose-graph solver above "
                f"{_DENSE_VMAX} vertices is not ported yet: ROADMAP.md queue 1 item 11")
        idx_of = {vid: k for k, vid in enumerate(ids)}
        dev = self.device

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        poses = t(np.stack([g.vertices[v].T for v in ids]))
        fixed = t([g.vertices[v].fixed for v in ids], torch.bool)
        e_i = t([idx_of[e.id1] for e in g.edges], torch.int64)
        e_j = t([idx_of[e.id2] for e in g.edges], torch.int64)
        e_Zinv = t(np.stack([se3_np.inverse(e.T) for e in g.edges]))
        e_info = t(np.stack([e.information for e in g.edges]))
        e_robust = t([e.robust for e in g.edges], torch.bool)
        kernel = _KERNELS.get(str(self.robust_kernel).strip().lower(), _KERNEL_NONE)

        poses_out, final_chi, self.last_iters = optimize_dense(
            poses, fixed, e_i, e_j, e_Zinv, e_info, e_robust,
            n_iters=n_iters, kernel=kernel)
        poses_out = poses_out.cpu().numpy().astype(np.float64)
        for k, vid in enumerate(ids):
            if not g.vertices[vid].fixed:
                # re-orthonormalize before storing (fp32 drift)
                T = poses_out[k]
                q = se3_np.rot_to_quat(T[:3, :3])
                g.vertices[vid].T = se3_np.make_isometry(se3_np.quat_to_rot(q), T[:3, 3])
        return float(final_chi)


class SLAMEnd:
    """Backend shell (src/GraphicEnd.h:226-256): owns the global
    optimizer; init(graphic_end) installs the frontend's
    `robust_kernel` config key."""

    def __init__(self, device=None):
        self.optimizer = PoseGraphOptimizer(device=device)

    def init(self, graphic_end=None):
        self.graphic_end = graphic_end
        params = getattr(graphic_end, "params", None)
        if params is not None:
            self.optimizer.robust_kernel = params.GetPara("robust_kernel")

    @property
    def globalOptimizer(self) -> PoseGraphOptimizer:  # noqa: N802 (parity)
        return self.optimizer
