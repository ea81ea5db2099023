"""Image-space ops: plane membership images and histogram equalization
(counterpart of slam3d_gx_tpu/ops/imageproc.py).

`equalize_hist` runs on kernels K1 (`histogram256`) and K2
(`apply_lut256`) for images on the card; the 256-element CDF and LUT
between them are plain torch on the same device.
"""

from __future__ import annotations

import torch

from ..kernels import apply_lut256, histogram256


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


def equalize_lut(hist: torch.Tensor, total: int) -> torch.Tensor:
    """cv::equalizeHist's LUT from a 256-bin histogram -> (256,) float32.

    The first non-empty bin maps to 0 and the rest follow the cumulative
    histogram scaled by 255/(total - hist[first]). A constant image gets
    the identity LUT, so applying it returns the image unchanged.
    """
    hist = hist.to(torch.int32)
    i0 = torch.argmax((hist > 0).to(torch.int32))
    h0 = hist[i0]
    scale = 255.0 / torch.clamp(total - h0, min=1)
    csum = torch.cumsum(hist, dim=0)
    rel = (csum - csum[i0]).to(torch.float32)
    lut = torch.clamp(torch.round(rel * scale), 0, 255)
    idx = torch.arange(256, device=hist.device)
    lut = torch.where(idx <= i0, 0.0, lut)
    return torch.where(h0 == total, idx.to(torch.float32), lut)


def equalize_hist(image: torch.Tensor) -> torch.Tensor:
    """cv::equalizeHist clone on an integer-valued (H,W) image -> uint8."""
    hist = histogram256(image)
    return apply_lut256(image, equalize_lut(hist, image.numel()))
