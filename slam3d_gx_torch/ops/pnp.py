"""Batched RANSAC PnP: P3P minimal solves + Gauss-Newton refinement
(counterpart of slam3d_gx_tpu/ops/pnp.py).

cv::solvePnPRansac as the reference calls it (src/GraphicEnd.cpp:542,
595,615), as one batch of B hypotheses:

  sample B 3-point subsets -> Grunert P3P quartics (Durand-Kerner roots)
  -> 12 candidate poses per subset -> score the candidates on a strided
  subset, re-score the top 32 on all points -> best by inlier count ->
  damped Gauss-Newton polish on the winner's inliers.

The hypothesis uniforms `u` (B,3) are an argument, so a caller can hand
in the reference's draws. Every solve takes an optional leading batch
dimension G (the reference vmaps the per-plane solves over it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.refine_lm import refine_lm
from . import lie
from .features.common import top_k
from .polynomial import quartic_roots, real_roots_mask

# candidates are first scored on a strided subset of this many points
PRESCORE = 128


class PnPResult(NamedTuple):
    rvec: torch.Tensor       # (...,3)
    tvec: torch.Tensor       # (...,3)
    inliers: torch.Tensor    # (...,N) bool
    n_inliers: torch.Tensor  # (...,) int
    ok: torch.Tensor         # (...,) bool: a model with >= min_inliers


# ---------------------------------------------------------------------------
# P3P (Grunert)
# ---------------------------------------------------------------------------


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)


def _frame(a, b, c):
    """(...,3) points -> (...,3,3) orthonormal frame with columns
    e1 along b-a, e2 the orthogonalized c-a, e3 = e1 x e2."""
    e1 = _normalize(b - a)
    v = c - a
    e2 = _normalize(v - torch.sum(v * e1, dim=-1, keepdim=True) * e1)
    return torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)


def p3p_grunert(P: torch.Tensor, f: torch.Tensor):
    """Grunert's P3P: world triplets + unit bearing triplets -> candidates.

    Args:
      P: (...,3,3) world points (rows); f: (...,3,3) unit bearings.
    Returns:
      R (...,12,3,3), t (...,12,3), valid (...,12): 4 quartic roots x 3
      Newton seeds (root, root+4e-3, root-4e-3), duplicates harmless.
    """
    P1, P2, P3 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]

    def sq(v):
        return v[..., 0] ** 2 + v[..., 1] ** 2 + v[..., 2] ** 2

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    a2, b2, c2 = sq(P2 - P3), sq(P1 - P3), sq(P1 - P2)
    ca, cb, cg = dot(f2, f3), dot(f1, f3), dot(f1, f2)  # cos(alpha, beta, gamma)

    b2s = torch.where(b2 > 1e-12, b2, 1e-12)
    A = a2 / b2s
    B = c2 / b2s
    amc = (a2 - c2) / b2s  # (a^2 - c^2)/b^2

    # Haralick et al., Grunert quartic coefficients in v (s3 = v s1)
    A4 = (amc - 1.0) ** 2 - 4.0 * B * ca**2
    A3 = 4.0 * (amc * (1.0 - amc) * cb - (1.0 - (A + B)) * ca * cg
                + 2.0 * B * ca**2 * cb)
    A2 = 2.0 * (amc**2 - 1.0 + 2.0 * amc**2 * cb**2 + 2.0 * (1.0 - B) * ca**2
                - 4.0 * (A + B) * ca * cb * cg + 2.0 * (1.0 - A) * cg**2)
    A1 = 4.0 * (-amc * (1.0 + amc) * cb + 2.0 * A * cg**2 * cb
                - (1.0 - (A + B)) * ca * cg)
    A0 = (1.0 + amc) ** 2 - 4.0 * A * cg**2
    roots = quartic_roots(torch.stack([A4, A3, A2, A1, A0], dim=-1))  # (...,4)

    is_real = real_roots_mask(roots, rel_tol=5e-2)
    # perturbed seeds recover the sibling of a near-double root that the
    # fp32 root finder resolves only to ~sqrt(eps)
    v = torch.cat([roots.real, roots.real + 4e-3, roots.real - 4e-3], dim=-1)
    v_ok = is_real.repeat((1,) * (is_real.dim() - 1) + (3,)) & (v > 1e-6)

    amc_, ca_, cb_, cg_ = amc[..., None], ca[..., None], cb[..., None], cg[..., None]
    denom_u = 2.0 * (cg_ - v * ca_)
    u = ((-1.0 + amc_) * v**2 - 2.0 * amc_ * cb_ * v + 1.0 + amc_) \
        / torch.where(torch.abs(denom_u) > 1e-9, denom_u, 1e-9)

    # Newton-polish (u,v) on the law-of-cosines constraints
    Ac, Bc = A[..., None], B[..., None]
    for _ in range(4):
        F1 = (u * u + v * v - 2 * u * v * ca_) - Ac * (1 + v * v - 2 * v * cb_)
        F2 = (1 + u * u - 2 * u * cg_) - Bc * (1 + v * v - 2 * v * cb_)
        j11 = 2 * u - 2 * v * ca_
        j12 = 2 * v - 2 * u * ca_ - Ac * (2 * v - 2 * cb_)
        j21 = 2 * u - 2 * cg_
        j22 = -Bc * (2 * v - 2 * cb_)
        det = j11 * j22 - j12 * j21
        det = torch.where(torch.abs(det) > 1e-9, det, 1e-9)
        u, v = u - (j22 * F1 - j12 * F2) / det, v - (-j21 * F1 + j11 * F2) / det

    s1sq = b2s[..., None] / (1.0 + v**2 - 2.0 * v * cb_)
    s1 = torch.sqrt(torch.clamp(s1sq, min=1e-12))
    valid = v_ok & (u > 1e-6) & (s1sq > 1e-12)

    # camera-frame points, then absolute orientation from the two frames
    X1 = s1[..., None] * f1[..., None, :]
    X2 = (u * s1)[..., None] * f2[..., None, :]
    X3 = (v * s1)[..., None] * f3[..., None, :]
    EX = _frame(X1, X2, X3)                     # (...,12,3,3)
    EP = _frame(P1, P2, P3)[..., None, :, :]    # (...,1,3,3)
    R = EX @ EP.transpose(-1, -2)
    cX = (X1 + X2 + X3) / 3.0
    cP = ((P1 + P2 + P3) / 3.0)[..., None, :]
    t = cX - (R @ cP[..., None])[..., 0]
    return R, t, valid


# ---------------------------------------------------------------------------
# projection + scoring
# ---------------------------------------------------------------------------


def _project_uvz(R, t, pts, fx, fy, cx, cy):
    """R (...,C,3,3), t (...,C,3), pts (...,N,3) -> u, v, z each (...,C,N),
    accumulated in the reference's order."""
    x, y, z = (pts[..., None, :, k] for k in range(3))
    r = R[..., None]
    px = r[..., 0, 0, :] * x + r[..., 0, 1, :] * y + r[..., 0, 2, :] * z + t[..., 0:1]
    py = r[..., 1, 0, :] * x + r[..., 1, 1, :] * y + r[..., 1, 2, :] * z + t[..., 1:2]
    pz = r[..., 2, 0, :] * x + r[..., 2, 1, :] * y + r[..., 2, 2, :] * z + t[..., 2:3]
    safe_z = torch.where(torch.abs(pz) > 1e-9, pz, 1e-9)
    return px * fx / safe_z + cx, py * fy / safe_z + cy, pz


def reprojection_errors(rvec, tvec, obj, img, fx, fy, cx, cy):
    """(...,3),(...,3),(...,N,3),(...,N,2) -> (...,N) pixel errors, inf
    behind the camera."""
    u, v, z = _project_uvz(lie.rodrigues(rvec)[..., None, :, :], tvec[..., None, :],
                           obj, fx, fy, cx, cy)
    u, v, z = u[..., 0, :], v[..., 0, :], z[..., 0, :]
    du = u - img[..., 0]
    dv = v - img[..., 1]
    return torch.where(z > 0, torch.sqrt(du * du + dv * dv), torch.inf)


def _inlier_votes(R, t, obj, img, mask, fx, fy, cx, cy, th2):
    """(G,C,N) squared-distance consensus of every candidate."""
    u, v, z = _project_uvz(R, t, obj, fx, fy, cx, cy)
    du = u - img[:, None, :, 0]
    dv = v - img[:, None, :, 1]
    return (du * du + dv * dv < th2) & (z > 0) & mask[:, None, :]


# ---------------------------------------------------------------------------
# Gauss-Newton refinement on SE(3)
# ---------------------------------------------------------------------------


def refine_pnp(rvec, tvec, obj, img, weights, fx, fy, cx, cy, iters: int = 10):
    """Levenberg-damped Gauss-Newton on the reprojection objective.

    weights: (...,N) float (0 masks a correspondence out). Leading batch
    dims (at most one) solve independent problems together. On the card
    all the iterations are one kernel launch (kernels/refine_lm.py); on
    the CPU its plain version runs.
    """
    return refine_lm(rvec, tvec, obj, img, weights, fx, fy, cx, cy, iters=iters)


# ---------------------------------------------------------------------------
# full RANSAC PnP
# ---------------------------------------------------------------------------


def solve_pnp_ransac(obj, img, mask, fx, fy, cx, cy, u,
                     reproj_thresh: float = 8.0, min_inliers: int = 4,
                     refine_iters: int = 10, guess_rvec=None,
                     guess_tvec=None) -> PnPResult:
    """obj (...,N,3) world, img (...,N,2) pixels, mask (...,N) valid
    correspondences, u (...,B,3) uniforms in [0,1) that pick the B
    triplets (B = hypotheses). At most one leading batch dim.

    cv::solvePnPRansac's contract: the inlier set of the best model at
    `reproj_thresh`, with the pose refined on those inliers. A guess
    joins the pool as one more candidate (useExtrinsicGuess) and skips
    the subset round. With more than PRESCORE points, candidates are
    first scored on a strided PRESCORE-point subset and only the top 32
    are scored on all N points.
    """
    single = obj.dim() == 2
    if single:
        obj, img, mask, u = obj[None], img[None], mask[None], u[None]
        if guess_rvec is not None:
            guess_rvec, guess_tvec = guess_rvec[None], guess_tvec[None]
    G, N = obj.shape[:2]
    obj = obj.to(torch.float32)
    img = img.to(torch.float32)
    gi = torch.arange(G, device=obj.device)[:, None]

    # bearings
    f = torch.stack([(img[..., 0] - cx) / fx, (img[..., 1] - cy) / fy,
                     torch.ones_like(img[..., 0])], dim=-1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    # triplets: uniform ranks over the valid rows, rank -> row
    nv = torch.sum(mask.to(torch.int64), dim=-1)
    cm = torch.cumsum(mask.to(torch.int64), dim=-1)
    r_rank = torch.minimum(
        torch.floor(u * nv[:, None, None].to(torch.float32)).to(torch.int64),
        torch.clamp(nv - 1, min=0)[:, None, None])
    r_rank = torch.clamp(r_rank, min=0)
    rows = torch.clamp(torch.searchsorted(cm, (r_rank + 1).reshape(G, -1)), max=N - 1)
    rows = rows.reshape(r_rank.shape)  # (G,B,3)
    P = obj[gi[:, :, None], rows]      # (G,B,3,3)
    F = f[gi[:, :, None], rows]
    distinct = ((r_rank[..., 0] != r_rank[..., 1]) & (r_rank[..., 0] != r_rank[..., 2])
                & (r_rank[..., 1] != r_rank[..., 2]) & (nv[:, None] >= 3))

    # candidates flattened slot-major (index s*B + b), the reference's order
    Rc, tc, vc = p3p_grunert(P, F)  # (G,B,12,...)
    Rc = Rc.transpose(1, 2).reshape(G, -1, 3, 3)
    tc = tc.transpose(1, 2).reshape(G, -1, 3)
    vf = (vc & distinct[..., None]).transpose(1, 2).reshape(G, -1)

    th2 = reproj_thresh * reproj_thresh
    if PRESCORE < N:
        sub = slice(None, None, N // PRESCORE)
        votes = _inlier_votes(Rc, tc, obj[:, sub][:, :PRESCORE], img[:, sub][:, :PRESCORE],
                              mask[:, sub][:, :PRESCORE], fx, fy, cx, cy, th2)
        counts_s = torch.where(vf, votes.sum(dim=-1), -1)
        # ties in index order: lax.top_k's, which decides the winner among equal counts
        top = top_k(counts_s, min(32, counts_s.shape[1]))[1]
        Rc, tc, vf = Rc[gi, top], tc[gi, top], vf[gi, top]

    if guess_rvec is not None:
        Rg = lie.rodrigues(guess_rvec.to(torch.float32))
        Rc = torch.cat([Rc, Rg[:, None]], dim=1)
        tc = torch.cat([tc, guess_tvec.to(torch.float32)[:, None]], dim=1)
        vf = torch.cat([vf, torch.ones_like(vf[:, :1])], dim=1)

    good = _inlier_votes(Rc, tc, obj, img, mask, fx, fy, cx, cy, th2)
    counts = torch.where(vf, good.sum(dim=-1), -1)
    best = torch.argmax(counts, dim=-1)  # (G,) first max
    g1 = gi[:, 0]
    rv, tv = refine_pnp(lie.inv_rodrigues(Rc[g1, best]), tc[g1, best], obj, img,
                        good[g1, best].to(torch.float32), fx, fy, cx, cy,
                        iters=refine_iters)
    inliers = (reprojection_errors(rv, tv, obj, img, fx, fy, cx, cy) < reproj_thresh) & mask
    n_inl = inliers.sum(dim=-1)
    ok = (counts[g1, best] >= min_inliers) & (n_inl >= min_inliers)
    res = PnPResult(rvec=rv, tvec=tv, inliers=inliers, n_inliers=n_inl, ok=ok)
    return PnPResult(*(a[0] for a in res)) if single else res
