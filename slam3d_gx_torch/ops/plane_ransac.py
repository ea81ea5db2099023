"""Batched-hypothesis plane RANSAC + iterative multi-plane extraction
(counterpart of slam3d_gx_tpu/ops/plane_ransac.py).

PCL SACSegmentation as the reference uses it (src/GraphicEnd.cpp:353-430):
up to `max_planes` planes while more than `percent` of the points
remain, inliers within `dist_thresh`, coefficients normalized so d >= 0,
inliers removed between rounds. Each round samples B triplets at once,
scores all B planes against all N points, keeps the best and refines it
with two masked least-squares passes.

The triplet draws come from a sampler: `sampler(p, remaining, B)` returns
(...,B,3) point indices for round p. `UniformSampler` draws uniformly
over the remaining points from a `torch.Generator`; `GumbelSampler`
replays the reference's `jax.random.categorical` draws from their Gumbel
noise, so the parity tests see the reference's exact indices.

Clouds may carry leading batch dimensions (...,N,3): the clouds are then
fitted together, as the reference vmaps `fit_plane` over keypoint
patches (planarFeatures).
"""

from __future__ import annotations

import torch


class UniformSampler:
    """Triplet indices drawn uniformly over the remaining points."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, p: int, remaining: torch.Tensor, hypotheses: int):
        batch = remaining.shape[:-1]
        u = torch.rand(batch + (hypotheses, 3), generator=self.generator,
                       device=remaining.device)
        cm = torch.cumsum(remaining.to(torch.int64), dim=-1)
        n = cm[..., -1:, None]
        rank = torch.minimum((u * n.to(torch.float32)).to(torch.int64),
                             torch.clamp(n - 1, min=0))
        # first index whose running count passes the rank
        idx = torch.searchsorted(cm, (rank + 1).reshape(batch + (-1,)))
        return torch.clamp(idx, max=remaining.shape[-1] - 1).reshape(rank.shape)


class GumbelSampler:
    """Replays `jax.random.categorical(key_p, logits, shape=(B,3))`:
    argmax over points of gumbel[p] + logits, logits 0 on the remaining
    points and -1e30 elsewhere. gumbel: (...,P,B,3,N) float32, with the
    clouds' batch dimensions in front."""

    def __init__(self, gumbel: torch.Tensor):
        self.gumbel = gumbel

    def __call__(self, p: int, remaining: torch.Tensor, hypotheses: int):
        logits = torch.where(remaining, 0.0, -1e30)[..., None, None, :]
        return torch.argmax(self.gumbel[..., p, :, :, :] + logits, dim=-1)


def _plane_lsq(xyz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted total-least-squares plane through masked points -> (...,4)
    [n, d], |n| = 1: smallest eigenvector of the weighted covariance."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    c = torch.sum(xyz * w[..., None], dim=-2) / wsum
    centered = xyz - c[..., None, :]
    x = centered * w[..., None]
    cov = (x.transpose(-1, -2) @ centered) / wsum[..., None]
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    n = vecs[..., :, 0]
    d = -(n[..., None, :] @ c[..., :, None])[..., 0]
    return torch.cat([n, d], dim=-1)


def _point_plane_abs_dist(xyz, coeff):
    return torch.abs((xyz @ coeff[..., :3, None])[..., 0] + coeff[..., 3:])


def _take(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(...,N,3) points, (...,M) indices -> (...,M,3)."""
    return torch.gather(xyz, -2, idx[..., None].expand(idx.shape + (3,)))


def extract_planes(xyz, mask, sampler, max_planes: int = 3,
                   dist_thresh: float = 0.08, percent: float = 0.2,
                   hypotheses: int = 256, min_inliers: int = 3):
    """Iterative RANSAC plane extraction over a fixed-size masked cloud.

    Args:
      xyz: (...,N,3) float32; mask: (...,N) bool valid points; sampler:
        see the module docstring.
    Returns:
      coeffs (...,P,4) [a,b,c,d] with d >= 0; plane_masks (...,P,N) bool
      inlier sets; valid (...,P) bool real plane slots; remaining (...,N)
      bool points never claimed by a plane.
    """
    xyz = xyz.to(torch.float32)
    n_total = torch.sum(mask, dim=-1).to(torch.float32)
    remaining = mask
    coeffs, masks, valids = [], [], []
    for p in range(max_planes):
        idx = sampler(p, remaining, hypotheses)  # (...,B,3)
        p0, p1, p2 = (_take(xyz, idx[..., j]) for j in range(3))
        n = torch.linalg.cross(p1 - p0, p2 - p0)
        nn = torch.linalg.vector_norm(n, dim=-1)
        ok = nn > 1e-9
        n = n / torch.where(ok, nn, 1.0)[..., None]
        d = -torch.sum(n * p0, dim=-1)

        dist = torch.abs(n @ xyz.transpose(-1, -2) + d[..., None])
        inl = (dist < dist_thresh) & remaining[..., None, :]
        counts = torch.where(ok, inl.sum(dim=-1), -1)
        best = torch.argmax(counts, dim=-1)

        # two refine rounds (PCL optimizeCoefficients analog); an index
        # tensor, not a 0-d one, so nothing is read back to the host
        m = torch.gather(inl, -2, best[..., None, None].expand(best.shape + (1, inl.shape[-1])))
        m = m[..., 0, :]
        coeff = _plane_lsq(xyz, m.to(xyz.dtype))
        m = (_point_plane_abs_dist(xyz, coeff) < dist_thresh) & remaining
        coeff = _plane_lsq(xyz, m.to(xyz.dtype))
        m = (_point_plane_abs_dist(xyz, coeff) < dist_thresh) & remaining

        # d >= 0 normalization (reference src/GraphicEnd.cpp:383-387)
        coeff = torch.where(coeff[..., 3:] < 0, -coeff, coeff)

        enough_left = torch.sum(remaining, dim=-1).to(torch.float32) > percent * n_total
        valid = enough_left & (m.sum(dim=-1) >= min_inliers)
        remaining = torch.where(valid[..., None], remaining & ~m, remaining)
        coeffs.append(coeff)
        masks.append(m & valid[..., None])
        valids.append(valid)
    return (torch.stack(coeffs, dim=-2), torch.stack(masks, dim=-2),
            torch.stack(valids, dim=-1), remaining)


def fit_plane(xyz, mask, sampler, dist_thresh: float = 0.01, hypotheses: int = 64):
    """Single-plane RANSAC (SampleConsensusModelPlane, reference
    src/planarFeatures.cpp:118-125) over (...,N,3) clouds. Returns
    (coeff (...,4), inlier mask (...,N), inlier count (...,))."""
    coeffs, masks, _, _ = extract_planes(xyz, mask, sampler, max_planes=1,
                                         dist_thresh=dist_thresh, percent=0.0,
                                         hypotheses=hypotheses)
    return coeffs[..., 0, :], masks[..., 0, :], masks[..., 0, :].sum(dim=-1)
