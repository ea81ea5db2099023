"""Brute-force descriptor matching (counterpart of slam3d_gx_tpu/ops/match.py).

cv::FlannBasedMatcher::match as the reference uses it for descriptors
(src/GraphicEnd.cpp:486-520) and plane coefficients (459-484), plus its
good-match filter: keep matches with distance <= 3 * min_dist, where
min_dist starts at 100 (496-517). Exact nearest neighbour from one
matrix product; every function takes optional leading batch dims.
"""

from __future__ import annotations

import torch


def l2_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...,M,D),(...,N,D) -> (...,M,N) Euclidean distances (fp32)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = torch.sum(a * a, dim=-1, keepdim=True)
    bb = torch.sum(b * b, dim=-1, keepdim=True)
    d2 = aa + bb.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2))
    return torch.sqrt(torch.clamp(d2, min=0.0))


def match_nn(desc1, valid1, desc2, valid2):
    """Nearest neighbour in desc2 for every desc1 row.

    Returns (train_idx (...,M) int64, distance (...,M) f32, valid (...,M)
    bool). Invalid trains are excluded; a query with no valid train, or
    an invalid query, gets valid=False and distance inf. Ties take the
    first index, as jnp.argmin does.
    """
    d = l2_distance_matrix(desc1, desc2)
    d = torch.where(valid2[..., None, :], d, torch.inf)
    dist = torch.amin(d, dim=-1)
    idx = torch.argmin(d, dim=-1)
    ok = valid1 & torch.isfinite(dist)
    return idx, torch.where(ok, dist, torch.inf), ok


def good_match_filter(dist, valid, ratio: float = 3.0, init_min: float = 100.0,
                      floor: float = 0.0):
    """The reference's min-dist ratio gate over the last axis:
    min_dist = min(init_min, min(valid distances)); keep
    dist <= max(ratio * min_dist, floor)."""
    min_dist = torch.amin(torch.where(valid, dist, torch.inf), dim=-1, keepdim=True)
    min_dist = torch.clamp(min_dist, max=init_min)
    bound = torch.clamp(ratio * min_dist, min=floor)
    return valid & (dist <= bound)


def match_planes(coeffs1, valid1, coeffs2, valid2):
    """Plane-set matcher: (a,b,c,d) coefficients as descriptors
    (reference src/GraphicEnd.cpp:459-484; no ratio filter there)."""
    return match_nn(coeffs1, valid1, coeffs2, valid2)
