"""Image-space ops: plane membership images and histogram equalization
(counterpart of slam3d_gx_tpu/ops/imageproc.py).

`equalize_hist` is one launch of the kernel `equalize_hist256` for an
image on the card (histogram, CDF, LUT and lookup fused); on the CPU it
is that kernel's plain version, built from `equalize_lut`.
"""

from __future__ import annotations

import torch

from ..kernels import equalize_hist256
from ..kernels.equalize import equalize_lut  # noqa: F401


def plane_membership_images(xyz_img, valid_img, coeffs, plane_valid, gray,
                            dist_thresh):
    """Per-plane coverage masks computed analytically in image space.

    A pixel belongs to plane p iff its backprojected point lies within
    `dist_thresh` of the plane, earlier planes claiming pixels first
    (the reference removes inliers between iterations).

    Args:
      xyz_img: (H,W,3); valid_img: (H,W) bool; coeffs: (P,4);
      plane_valid: (P,) bool; gray: (H,W).
    Returns:
      images (P,H,W) uint8 (gray under mask), masks (P,H,W) bool.
    """
    dists = torch.abs(
        torch.tensordot(xyz_img, coeffs[:, :3], dims=([2], [1]))
        + coeffs[:, 3])  # (H,W,P)
    member = (dists < dist_thresh) & valid_img[..., None] & plane_valid
    # exclusive claim by plane order
    prior = torch.cumsum(member.to(torch.int32), dim=-1) - member.to(torch.int32)
    masks = (member & (prior == 0)).permute(2, 0, 1)
    images = torch.where(masks, gray.to(torch.uint8)[None], 0).to(torch.uint8)
    return images, masks


def equalize_hist(image: torch.Tensor) -> torch.Tensor:
    """cv::equalizeHist clone on an integer-valued (H,W) image -> uint8."""
    return equalize_hist256(image)
