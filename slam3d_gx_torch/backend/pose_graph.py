"""Pose-graph backend: SE(3) Levenberg-Marquardt on tensors
(counterpart of slam3d_gx_tpu/backend/pose_graph.py).

The reference's g2o assembly (SLAMEnd: CSparse -> BlockSolver_6_3 ->
Levenberg + a robust kernel built by name, src/GraphicEnd.h:223-256) and
SparseOptimizer::optimize (src/GraphicEnd.cpp:669-670). Edges are
linearized as one batch (residual = se3_log(Zij^-1 Xi^-1 Xj), Jacobians
by forward-mode autodiff of local right perturbations), robust weights
applied per edge, and the damped normal equations solved either

- densely, as one (6V,6V) system, up to `_DENSE_VMAX` vertices; or
- matrix-free, by block-Jacobi preconditioned conjugate gradients on the
  per-edge 6x6 blocks (O(E) memory), above it: the reference's vertex
  ids allow 10k frames (src/const.h:25), where a dense H would take
  ~14 GB.

With a mesh (`optimize(mesh=...)`, parallel/mesh.py) the edges are
padded to a multiple of the mesh's dp axis with edges of zero
information, which add nothing, and each dp rank linearizes its block of
them. The dense solve all-reduces the partial H, g and chi2 over the dp
group, once per system, and every rank runs the same solve. The CG solve
all-reduces g, the block-Jacobi blocks and chi2 once per system and each
matvec's sums per vertex in every CG iteration; every rank then holds
the same values, reads the same stop flag and makes the same LM choice.

Each LM iteration assembles the system once and reads back one pair of
chi2 values; the loop stops early on a chi2 plateau, like g2o's
terminate action. Fixed vertices get identity rows (gauge fixing; vertex
0 is fixed by the frontend). The solver is picked by the vertex bucket
of the JAX package (the next power of two >= 16), so both packages take
the same solver and the same CG iteration cap for a graph; the port
itself pads nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import se3 as se3_np
from ..io import g2o_io
from ..ops import lie
from ..parallel import mesh as mesh_mod

# robust-kernel codes; an unknown name constructs no kernel, as g2o's
# factory does (src/GraphicEnd.h:245)
_KERNEL_NONE, _KERNEL_CAUCHY, _KERNEL_HUBER = 0, 1, 2
_KERNELS = {"cauchy": _KERNEL_CAUCHY, "huber": _KERNEL_HUBER}

# largest vertex bucket solved densely; the CG solver runs above it
_DENSE_VMAX = 512
# CG iterations between two reads of its stop flag: the loop runs on
# without waiting for the host, and a converged solve is frozen in place
_CG_CHECK_EVERY = 32


def _bucket(n: int, base: int = 16) -> int:
    """The JAX package's vertex capacity of an n-vertex graph."""
    c = base
    while c < n:
        c *= 2
    return c


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


def _summed(reduce: Optional[Callable], *parts):
    """`parts` summed over the ranks by `reduce` (in place, one
    collective for all of them); as they are without it."""
    if reduce is None:
        return parts
    flat = reduce(torch.cat([p.reshape(-1) for p in parts]))
    return tuple(c.view_as(p) for c, p in zip(flat.split([p.numel() for p in parts]), parts))


def _lm_loop(system, solve, apply_delta, poses, n_iters: int, rel_tol: float = 1e-8):
    """Shared LM loop: one system assembly per iteration (the candidate's
    evaluation is the next iteration's system) and one readback, the
    current and the candidate chi2, on which the host decides. Stops on
    a chi2 plateau or a saturated damping factor; n_iters is a cap, as
    the reference's optimize_step=200 is. Returns (poses, chi2, iters)."""
    sys_cur = system(poses)
    lam = 1e-4
    it = 0
    while it < n_iters:
        cand = apply_delta(poses, solve(sys_cur, lam))
        sys_new = system(cand)
        # fp32 on the host, as the reference decides on the device
        chi, chi_new = torch.stack([sys_cur[0], sys_new[0]]).cpu().numpy()
        it += 1
        if chi_new < chi:
            poses, sys_cur = cand, sys_new
            if (chi - chi_new) / max(chi, np.float32(1e-12)) < rel_tol:
                break
            lam = max(lam * 0.5, 1e-8)
        else:
            if lam >= 1e6:
                break
            lam = min(lam * 4.0, 1e6)
    return poses, sys_cur[0], it


def optimize_dense(poses, fixed, e_i, e_j, e_Zinv, e_info, e_robust,
                   n_iters: int, kernel: int, cauchy_delta: float = 1.0,
                   reduce: Optional[Callable] = None):
    """LM with a dense (6V,6V) solve. poses (V,4,4) -> (poses, chi2, iters).
    `reduce` sums a tensor over the ranks that hold the other edges, in
    place (see the module docstring)."""
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
        return _summed(reduce, chi, H, g)

    def solve(sys_cur, lam):
        _, H, g = sys_cur
        Hd = H.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
        Hd = torch.where(fmask[:, None] & fmask[None, :], Hd, 0.0)
        Hd[diag, diag] += torch.where(fmask, lam * (torch.diagonal(Hd) + 1e-6), 1.0)
        gd = torch.where(fmask, g.reshape(-1), 0.0)
        return torch.linalg.solve_ex(Hd, -gd)[0].reshape(V, 6)

    def apply_delta(p, dx):
        return p @ lie.se3_exp(dx * free[:, None])

    return _lm_loop(system, solve, apply_delta, poses, n_iters)


def _pcg(matvec, precond, b, maxiter: int, tol: float = 1e-8):
    """Preconditioned CG with jax.scipy.sparse.linalg.cg's recurrence and
    stop rule: x0 = 0, r0 = b, p0 = z0 = M(r0), gamma = <r, z>; iterate
    while <r, r> > tol^2 <b, b> and k < maxiter. The stop test stays on
    the device: once it holds, x, r, p and gamma are frozen by
    torch.where, which gives the result of stopping there, and the host
    reads the flag only every _CG_CHECK_EVERY iterations. Returns
    (x, iterations as a device tensor)."""

    def dot(u, v):
        return torch.sum(u * v)

    atol2 = tol * tol * dot(b, b)
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    gamma = dot(r, p)
    active = torch.ones((), dtype=torch.bool, device=b.device)
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    for k in range(maxiter):
        active = active & (dot(r, r) > atol2)
        Ap = matvec(p)
        alpha = gamma / dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        gamma_new = dot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        iters = iters + active.to(torch.int32)
        if (k + 1) % _CG_CHECK_EVERY == 0 and not bool(active):
            break
    return x, iters


def optimize_cg(poses, fixed, e_i, e_j, e_Zinv, e_info, e_robust,
                n_iters: int, kernel: int, maxiter: int, cauchy_delta: float = 1.0,
                cg_iters: Optional[list] = None, reduce: Optional[Callable] = None):
    """LM with a matrix-free block-sparse CG solve: H stays as per-edge
    6x6 blocks, applied edge by edge, so no (6V,6V) matrix is formed
    (SURVEY.md section 2.2, g2o row "or via CG"). maxiter caps each CG
    solve. With `cg_iters` a list, each LM step appends its CG
    iterations (a device tensor) to it. `reduce` as in optimize_dense.
    poses (V,4,4) -> (poses, chi2, iters)."""
    V = poses.shape[0]
    free = ~fixed
    fcol = free[:, None]
    e_ij = torch.cat([e_i, e_j])
    eye6 = torch.eye(6, dtype=poses.dtype, device=poses.device)
    # sums per vertex in one fixed order, on every device: a CUDA
    # index_add_ adds in the order its atomics land, so each matvec would
    # round differently and CG's recursive residual would stall above its
    # tolerance where the CPU's reaches it
    order = torch.argsort(e_ij, stable=True)
    degree = torch.zeros(V, dtype=torch.int64, device=poses.device).index_add_(
        0, e_ij, torch.ones_like(e_ij))

    def scatter(vals):
        """(2E, ...) rows, one per edge end -> (V, ...) sums per vertex."""
        return torch.segment_reduce(vals[order], "sum", lengths=degree, unsafe=True,
                                    initial=0.0)

    def system(p):
        chi, Bii, Bjj, Bij, g_i, g_j = _edge_terms(
            p, e_i, e_j, e_Zinv, e_info, e_robust, kernel, cauchy_delta)
        g = scatter(torch.cat([g_i, g_j]))
        # each edge's (12,12) block [[Bii, Bij], [Bij^T, Bjj]] of H
        B = torch.cat([torch.cat([Bii, Bij], -1),
                       torch.cat([Bij.transpose(-1, -2), Bjj], -1)], -2)
        # the 6x6 diagonal blocks of H, for the block-Jacobi preconditioner
        Hb = scatter(torch.cat([Bii, Bjj]))
        chi, g, Hb = _summed(reduce, chi, g, Hb)
        return chi, B, g, Hb

    def solve(sys_cur, lam):
        _, B, g, Hb = sys_cur
        damp = lam * (torch.diagonal(Hb, dim1=-2, dim2=-1) + 1e-6)
        # full 6x6 blocks, not scalar Jacobi: a chain's low-frequency
        # modes crawl ~1 vertex a matvec under the scalar form. inv_ex:
        # inv would check its info tensor, and the host would wait on it
        Hb = Hb + torch.diag_embed(damp + 1e-6)
        Minv = torch.linalg.inv_ex(torch.where(free[:, None, None], Hb, eye6))[0]
        E = e_i.shape[0]

        def matvec(x):
            xm = x * fcol
            xe = xm[e_ij].reshape(2, E, 6).permute(1, 0, 2).reshape(E, 12)
            ye = (B @ xe[..., None])[..., 0]
            y = scatter(ye.reshape(E, 2, 6).permute(1, 0, 2).reshape(2 * E, 6))
            if reduce is not None:
                y = reduce(y)
            # identity on fixed coordinates (gauge fixing)
            return torch.where(fcol, y + damp * xm, x)

        def precond(x):
            return torch.where(fcol, (Minv @ (x * fcol)[..., None])[..., 0], x)

        dx, it = _pcg(matvec, precond, torch.where(fcol, -g, 0.0), maxiter)
        if cg_iters is not None:
            cg_iters.append(it)
        return dx

    def apply_delta(p, dx):
        return p @ lie.se3_exp(dx * fcol)

    return _lm_loop(system, solve, apply_delta, poses, n_iters)


def _edge_shard(edges, mesh):
    """This dp rank's block of the edge arrays (e_i, e_j, e_Zinv, e_info,
    e_robust), padded to a multiple of dp with edges of zero information
    (vertex 0 to itself, not robust): chi2, blocks and gradient all zero."""
    e_i, e_j, e_Zinv, e_info, e_robust = edges
    E = e_i.shape[0]
    E_pad = mesh_mod.pad_to_multiple(E, mesh_mod.axis_size(mesh, mesh_mod.DP_AXIS))
    if E_pad != E:
        pad = E_pad - E

        def ext(x, fill):
            return torch.cat([x, fill.expand((pad,) + tuple(x.shape[1:]))])

        eye = torch.eye(4, dtype=e_Zinv.dtype, device=e_Zinv.device)
        e_i, e_j = ext(e_i, e_i.new_zeros(())), ext(e_j, e_j.new_zeros(()))
        e_Zinv, e_info = ext(e_Zinv, eye), ext(e_info, e_info.new_zeros((6, 6)))
        e_robust = ext(e_robust, e_robust.new_zeros(()))
    return tuple(mesh_mod.shard_rows(x, mesh, mesh_mod.DP_AXIS)
                 for x in (e_i, e_j, e_Zinv, e_info, e_robust))


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
        # the last optimize(): its solver, LM iterations and the CG
        # iterations of each LM step
        self.last_solver = None
        self.last_iters = 0
        self.last_cg_iters = []

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
    def optimize(self, n_iters: int = 200, solver: Optional[str] = None,
                 mesh=None) -> float:
        """Run LM on the whole graph; returns the final robust chi2.

        solver: "dense" | "cg" | None (dense up to a vertex bucket of
        _DENSE_VMAX, CG above). The CG solve runs up to max(250, bucket/2)
        iterations: information crosses O(1) vertices a matvec in a
        chain-dominated graph, so the cap scales with the graph. With
        `mesh`, the edges are split over its dp axis (see the module
        docstring); every rank of the mesh must call this on the same
        graph."""
        g = self.graph
        if not g.vertices or not g.edges:
            return 0.0
        ids = sorted(g.vertices)
        idx_of = {vid: k for k, vid in enumerate(ids)}
        vcap = _bucket(len(ids))
        if solver is None:
            solver = "dense" if vcap <= _DENSE_VMAX else "cg"
        if solver not in ("dense", "cg"):
            raise ValueError(f"solver {solver!r}: expected 'dense', 'cg' or None")
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
        edges = (e_i, e_j, e_Zinv, e_info, e_robust)
        reduce = None
        if mesh is not None:
            edges = _edge_shard(edges, mesh)

            def reduce(x):
                return mesh_mod.all_reduce_sum(x, mesh, mesh_mod.DP_AXIS)

        args = (poses, fixed, *edges)

        self.last_solver = solver
        if solver == "dense":
            poses_out, final_chi, self.last_iters = optimize_dense(
                *args, n_iters=n_iters, kernel=kernel, reduce=reduce)
            self.last_cg_iters = []
        else:
            cg_iters = []
            poses_out, final_chi, self.last_iters = optimize_cg(
                *args, n_iters=n_iters, kernel=kernel, maxiter=max(250, vcap // 2),
                cg_iters=cg_iters, reduce=reduce)
            self.last_cg_iters = torch.stack(cg_iters).tolist()
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
