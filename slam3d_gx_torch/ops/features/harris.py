"""GFTT (Shi-Tomasi min-eigenvalue) and Harris corner detectors
(counterpart of slam3d_gx_tpu/ops/features/harris.py).

Parity target: cv::GFTTDetector as FeatureDetector::create("GFTT") makes
it (qualityLevel 0.01, minDistance 1, blockSize 3). The quality gate is
relative to the image's largest response, as in cv::goodFeaturesToTrack;
minDistance is enforced by the NMS pooling radius.

For an image on the card the GFTT response comes from kernel K3
(kernels/min_eig.py); on the CPU from its plain version, which is
`min_eig_response` here. HARRIS uses the plain response on both devices.
"""

from __future__ import annotations

import torch

from ...kernels import min_eig as k3
from .common import Keypoints, topk_keypoints


def _structure_tensor(img: torch.Tensor, block_radius: int = 1):
    return k3.structure_tensor(img, block_radius)


def min_eig_response(img: torch.Tensor, block_radius: int = 1) -> torch.Tensor:
    """Shi-Tomasi: smaller eigenvalue of the 2x2 structure tensor (K3's
    plain version)."""
    return k3.min_eig_response_plain(img, block_radius)


def harris_response(img: torch.Tensor, k: float = 0.04, block_radius: int = 1):
    sxx, syy, sxy = _structure_tensor(img, block_radius)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def detect_gftt(img: torch.Tensor, max_kp: int = 512, quality_level: float = 0.01,
                use_harris: bool = False, harris_k: float = 0.04,
                nms_radius: int = 1) -> Keypoints:
    """img: (H,W) uint8/float. Returns fixed-capacity Keypoints."""
    if use_harris:
        resp = harris_response(img.to(torch.float32), harris_k)
    else:
        resp = k3.min_eig_response(img)
    resp = torch.clamp(resp, min=0.0)
    # the gate is relative to the whole map's maximum, border included
    thresh = torch.max(resp) * quality_level
    kps = topk_keypoints(resp, max_kp, threshold=0.0, nms_radius=nms_radius, border=2)
    return kps._replace(valid=kps.valid & (kps.response > thresh))
