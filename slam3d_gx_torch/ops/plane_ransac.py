"""Batched-hypothesis plane RANSAC + iterative multi-plane extraction
(counterpart of slam3d_gx_tpu/ops/plane_ransac.py).

PCL SACSegmentation as the reference uses it (src/GraphicEnd.cpp:353-430):
up to `max_planes` planes while more than `percent` of the points
remain, inliers within `dist_thresh`, coefficients normalized so d >= 0,
inliers removed between rounds. Each round samples B triplets at once,
scores all B planes against all N points, keeps the best and refines it
with two masked least-squares passes.

The triplet draws come from a sampler: `sampler(p, remaining, B)` returns
(B,3) point indices for round p. `UniformSampler` draws uniformly over
the remaining points from a `torch.Generator`; `GumbelSampler` replays
the reference's `jax.random.categorical` draws from their Gumbel noise,
so the parity tests see the reference's exact indices.
"""

from __future__ import annotations

import torch


class UniformSampler:
    """Triplet indices drawn uniformly over the remaining points."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, p: int, remaining: torch.Tensor, hypotheses: int):
        u = torch.rand((hypotheses, 3), generator=self.generator,
                       device=remaining.device)
        cm = torch.cumsum(remaining.to(torch.int64), dim=0)
        n = cm[-1]
        rank = torch.minimum((u * n.to(torch.float32)).to(torch.int64),
                             torch.clamp(n - 1, min=0))
        # first index whose running count passes the rank
        idx = torch.searchsorted(cm, rank + 1)
        return torch.clamp(idx, max=remaining.shape[0] - 1)


class GumbelSampler:
    """Replays `jax.random.categorical(key_p, logits, shape=(B,3))`:
    argmax over points of gumbel[p] + logits, logits 0 on the remaining
    points and -1e30 elsewhere. gumbel: (P,B,3,N) float32."""

    def __init__(self, gumbel: torch.Tensor):
        self.gumbel = gumbel

    def __call__(self, p: int, remaining: torch.Tensor, hypotheses: int):
        logits = torch.where(remaining, 0.0, -1e30)
        return torch.argmax(self.gumbel[p] + logits, dim=-1)


def _plane_lsq(xyz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted total-least-squares plane through masked points -> (4,)
    [n, d], |n| = 1: smallest eigenvector of the weighted covariance."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    c = torch.sum(xyz * w[:, None], dim=0) / wsum
    x = (xyz - c) * w[:, None]
    cov = (x.T @ (xyz - c)) / wsum
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    n = vecs[:, 0]
    return torch.cat([n, -torch.dot(n, c)[None]])


def _point_plane_abs_dist(xyz, coeff):
    return torch.abs(xyz @ coeff[:3] + coeff[3])


def extract_planes(xyz, mask, sampler, max_planes: int = 3,
                   dist_thresh: float = 0.08, percent: float = 0.2,
                   hypotheses: int = 256, min_inliers: int = 3):
    """Iterative RANSAC plane extraction over a fixed-size masked cloud.

    Args:
      xyz: (N,3) float32; mask: (N,) bool valid points; sampler: see the
        module docstring.
    Returns:
      coeffs (P,4) [a,b,c,d] with d >= 0; plane_masks (P,N) bool inlier
      sets; valid (P,) bool real plane slots; remaining (N,) bool points
      never claimed by a plane.
    """
    xyz = xyz.to(torch.float32)
    n_total = torch.sum(mask).to(torch.float32)
    remaining = mask
    coeffs, masks, valids = [], [], []
    for p in range(max_planes):
        idx = sampler(p, remaining, hypotheses)
        p0, p1, p2 = xyz[idx[:, 0]], xyz[idx[:, 1]], xyz[idx[:, 2]]
        n = torch.linalg.cross(p1 - p0, p2 - p0)
        nn = torch.linalg.vector_norm(n, dim=-1)
        ok = nn > 1e-9
        n = n / torch.where(ok, nn, 1.0)[:, None]
        d = -torch.sum(n * p0, dim=-1)

        dist = torch.abs(n @ xyz.T + d[:, None])
        inl = (dist < dist_thresh) & remaining
        counts = torch.where(ok, inl.sum(dim=1), -1)
        best = torch.argmax(counts)

        # two refine rounds (PCL optimizeCoefficients analog); a 0-d
        # index tensor would be read back to the host, a (1,) one is not
        m = inl[best.reshape(1)][0]
        coeff = _plane_lsq(xyz, m.to(xyz.dtype))
        m = (_point_plane_abs_dist(xyz, coeff) < dist_thresh) & remaining
        coeff = _plane_lsq(xyz, m.to(xyz.dtype))
        m = (_point_plane_abs_dist(xyz, coeff) < dist_thresh) & remaining

        # d >= 0 normalization (reference src/GraphicEnd.cpp:383-387)
        coeff = torch.where(coeff[3] < 0, -coeff, coeff)

        enough_left = torch.sum(remaining).to(torch.float32) > percent * n_total
        valid = enough_left & (m.sum() >= min_inliers)
        remaining = torch.where(valid, remaining & ~m, remaining)
        coeffs.append(coeff)
        masks.append(m & valid)
        valids.append(valid)
    return torch.stack(coeffs), torch.stack(masks), torch.stack(valids), remaining
