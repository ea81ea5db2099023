"""STAR (CenSurE) center-surround detector
(counterpart of slam3d_gx_tpu/ops/features/star.py).

cv::StarDetector as the reference experiments sweep it, in the box
bi-level form of the CenSurE paper: an inner (2n+1)^2 box against the
surrounding (6n+1)^2 ring, each area-normalized, at n = 1, 2, 3, 4; NMS
over (x, y, scale); edge-like maxima rejected by the ratio of the
structure tensor's trace and determinant (cv::StarDetector's line
threshold). Reads its boxes off SURF's integral image, with the same
precision property (surf.py).
"""

from __future__ import annotations

import torch

from . import surf
from .common import Keypoints, box_filter, sobel_gradients

_NS = (1, 2, 3, 4)  # inner half-sizes; outer = 3x


def detect_star(img: torch.Tensor, max_kp: int = 512, threshold: float = 3.0,
                line_thresh: float = 10.0) -> Keypoints:
    H, W = img.shape
    pad = 3 * _NS[-1] + 2
    iip = surf._pad_integral(surf._integral(img), pad)

    resps = []
    for n in _NS:
        inner = surf._box(iip, -n, -n, n + 1, n + 1, pad, H, W)
        outer = surf._box(iip, -3 * n, -3 * n, 3 * n + 1, 3 * n + 1, pad, H, W)
        a_in = (2 * n + 1) ** 2
        a_out = (6 * n + 1) ** 2 - a_in
        resps.append(torch.abs(inner / a_in - (outer - inner) / a_out))
    resp = torch.stack(resps)

    # line suppression: edge-like points of the structure tensor
    dx, dy = sobel_gradients(img.to(torch.float32))
    sxx = box_filter(dx * dx, 2)
    syy = box_filter(dy * dy, 2)
    sxy = box_filter(dx * dy, 2)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    edge_like = tr * tr >= line_thresh * torch.clamp(det, min=1e-9)
    return surf.scale_space_topk(resp, 3 * _NS[-1] + 1, max_kp, threshold,
                                 tuple(2.0 * (3 * n + 1) for n in _NS), reject=edge_like)
