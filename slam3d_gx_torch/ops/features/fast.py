"""FAST-9/16 corner detector and its grid-budgeted variant
(counterpart of slam3d_gx_tpu/ops/features/fast.py).

cv::FastFeatureDetector as the reference sweeps it ("FAST"/"GridFAST",
exp1_2_time.py:24-37; planarFeatures uses FAST at
src/planarFeatures.cpp:47): threshold 10, nonmax suppression on, an arc
of 9 on the 16-pixel Bresenham circle. The score is the sum of the
threshold-exceeding differences on the stronger side.

The 16 circle taps are rolled copies of the image; the wrap-around they
bring lies in the 3-pixel border, which the top-k excludes. "9
contiguous" is a cyclic window sum over the 16 tap masks.
"""

from __future__ import annotations

import torch

from .common import Keypoints, topk_keypoints

# OpenCV's circle of radius 3 (dx = col offset, dy = row offset)
_CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
_ARC = 9


def _has_arc(m: torch.Tensor, arc: int) -> torch.Tensor:
    """(16,H,W) bool -> (H,W): some `arc` cyclically consecutive taps all
    set. A window's count is a difference of the running count over the
    circle extended by its first arc-1 taps."""
    ext = torch.cat([m, m[:arc - 1]]).to(torch.int32)
    run = torch.cumsum(ext, dim=0)
    run = torch.cat([torch.zeros_like(run[:1]), run])
    return torch.any(run[arc:] - run[:-arc] == arc, dim=0)


def fast_score(img: torch.Tensor, threshold: float = 10.0, arc: int = _ARC) -> torch.Tensor:
    """(H,W) score map: the stronger side's excess over the threshold at
    corners, -inf elsewhere."""
    x = img.to(torch.float32)
    # tap[i][p] = x[p + (dy, dx)]
    taps = torch.stack([torch.roll(x, shifts=(-dy, -dx), dims=(0, 1)) for dx, dy in _CIRCLE])
    diff = taps - x[None]
    corner = _has_arc(diff > threshold, arc) | _has_arc(diff < -threshold, arc)
    score_b = torch.sum(torch.clamp(diff - threshold, min=0.0), dim=0)
    score_d = torch.sum(torch.clamp(-diff - threshold, min=0.0), dim=0)
    return torch.where(corner, torch.maximum(score_b, score_d), -torch.inf)


def detect_fast(img: torch.Tensor, threshold: float = 10.0, max_kp: int = 512,
                arc: int = _ARC) -> Keypoints:
    """img: (H,W) uint8/float. Fixed-capacity Keypoints, border 3 excluded."""
    return topk_keypoints(fast_score(img, threshold, arc), max_kp, threshold=0.0,
                          nms_radius=1, border=3, size=7.0)


def grid_budget(kps: Keypoints, H: int, W: int, max_kp: int, grid: int = 4) -> Keypoints:
    """Keep the max_kp / grid^2 strongest keypoints of each of the grid x
    grid cells of an (H,W) image."""
    per_cell = max(1, max_kp // (grid * grid))
    cu = torch.clamp((kps.uv[:, 0] * grid / W).to(torch.int32), 0, grid - 1)
    cv = torch.clamp((kps.uv[:, 1] * grid / H).to(torch.int32), 0, grid - 1)
    cell = torch.where(kps.valid, cv * grid + cu, grid * grid)
    # order by (cell, -response), ties in index order (jnp.lexsort's)
    by_resp = torch.sort(-kps.response, stable=True).indices
    order = by_resp[torch.sort(cell[by_resp], stable=True).indices]
    # rank inside each run of equal cells: position - the run's first position
    sorted_cell = cell[order]
    pos = torch.arange(order.shape[0], device=order.device)
    start = torch.cat([torch.ones_like(sorted_cell[:1], dtype=torch.bool),
                       sorted_cell[1:] != sorted_cell[:-1]])
    rank = pos - torch.cummax(torch.where(start, pos, 0), dim=0).values
    keep = torch.zeros_like(kps.valid).scatter(0, order, rank < per_cell)
    return kps._replace(valid=kps.valid & keep)


def detect_grid_fast(img: torch.Tensor, threshold: float = 10.0, max_kp: int = 512,
                     grid: int = 4, arc: int = _ARC) -> Keypoints:
    """GridAdaptedFeatureDetector(FAST): the image split into grid x grid
    cells, each keeping its max_kp / grid^2 strongest corners."""
    kps = detect_fast(img, threshold=threshold, max_kp=max_kp, arc=arc)
    return grid_budget(kps, *img.shape, max_kp, grid)
