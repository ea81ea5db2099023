"""Plain reference of a registration's claim: how many correspondences
the reported pose explains.

A registration reports a pose T (the first frame's keypoints into the
second camera) and the inlier count its RANSAC consensus reached. Given
the two frames' features, the reference rebuilds the correspondences the
way the reference system's GraphicEnd2 multiPnP does (nearest neighbour
by L2 descriptor distance, kept when within 3x the smallest distance,
capped at 100) and counts those that T reprojects within the RANSAC
threshold (8 px). Float64 throughout; imports nothing of the program.
"""

from __future__ import annotations

import torch

REPROJ_PX = 8.0


def _nn(da, va, db, vb):
    """Nearest neighbour of every row of da among the valid rows of db:
    (index, distance, valid); ties take the first index."""
    d = torch.cdist(da.to(torch.float64), db.to(torch.float64),
                    compute_mode="donot_use_mm_for_euclid_dist")
    d = torch.where(vb[..., None, :], d, torch.inf)
    dist, idx = torch.min(d, dim=-1)
    ok = va & torch.isfinite(dist)
    return idx, torch.where(ok, dist, torch.inf), ok


def _good(dist, ok):
    mind = torch.clamp(torch.amin(torch.where(ok, dist, torch.inf), dim=-1, keepdim=True),
                       max=100.0)
    return ok & (dist <= 3.0 * mind)


def correspondences(fa, fb):
    """(object points (N,3), image points (N,2), good (N,)) of the pair,
    from FrameFeatures-shaped fields (1,K,...) on one device."""
    idx, dist, ok = _nn(fa.desc, fa.kp_valid, fb.desc, fb.kp_valid)
    good = _good(dist, ok)
    img = torch.gather(fb.uv, 1, idx[..., None].expand(*idx.shape, 2))
    return fa.kp3d.reshape(-1, 3), img.reshape(-1, 2), good.reshape(-1)


def support(T, obj, img, good, cam: dict) -> int:
    """Correspondences that pose T (4,4) reprojects within REPROJ_PX."""
    T = torch.as_tensor(T, dtype=torch.float64, device=obj.device)
    p = obj.to(torch.float64) @ T[:3, :3].T + T[:3, 3]
    z = p[:, 2]
    zs = torch.where(z.abs() > 1e-9, z, 1e-9)
    du = p[:, 0] * cam["fx"] / zs + cam["cx"] - img[:, 0].to(torch.float64)
    dv = p[:, 1] * cam["fy"] / zs + cam["cy"] - img[:, 1].to(torch.float64)
    inl = good & (z > 0) & (torch.sqrt(du * du + dv * dv) < REPROJ_PX)
    return int(inl.sum())
