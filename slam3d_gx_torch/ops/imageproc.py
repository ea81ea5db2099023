"""Image-space ops: plane images (membership or splat) and histogram
equalization (counterpart of slam3d_gx_tpu/ops/imageproc.py).

`splat_plane_image` is the reference's plane image of
extractPlanesAndGenerateImage (src/GraphicEnd.cpp:397-416): each plane
point paints a (2*block+1)^2 square around its pixel, block =
int(-1.0*z + 10.0) clamped at 0. It is computed as a scatter-max of the
radius into the pixel grid, then R_MAX rounds of a 3x3 max-pool
dilation: a stamp of radius r has grown to its square after r rounds.

`equalize_hist` is one launch of the kernel `equalize_hist256` for an
image on the card (histogram, CDF, LUT and lookup fused); on the CPU it
is that kernel's plain version, built from `equalize_lut`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import equalize_hist256
from ..kernels.equalize import equalize_lut  # noqa: F401


# block = int(-1.0*z + 10.0) with z > 0 never exceeds 10
_R_MAX = 10


def splat_plane_image(xyz, mask, gray, fx, fy, cx, cy, height: int = 480,
                      width: int = 640):
    """Project the masked plane points and paint depth-adaptive squares.

    Args:
      xyz: (N,3) float32 points; mask: (N,) bool, or (P,N) for P planes
        over the same points; gray: (H,W).
    Returns:
      image uint8 and mask bool, (H,W) or (P,H,W): the gray frame under
      the coverage mask, zero elsewhere.
    """
    z = xyz[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    # clamp before the integer cast: only |u|, |v| below ~2^30 can reach the image
    u = torch.clamp(torch.round(xyz[:, 0] * fx / safe_z + cx), -2**30, 2**30).to(torch.int32)
    v = torch.clamp(torch.round(xyz[:, 1] * fy / safe_z + cy), -2**30, 2**30).to(torch.int32)
    r = torch.clamp(torch.trunc(10.0 - z), 0, _R_MAX).to(torch.int32)  # block

    # the reference paints the square clipped to the image even when its
    # center lies outside; a center more than R_MAX outside paints
    # nothing, and one within reach is clamped to the border with its
    # radius shrunk by the overhang
    in_reach = ((z > 0) & (u >= -_R_MAX) & (u < width + _R_MAX)
                & (v >= -_R_MAX) & (v < height + _R_MAX))
    uc = torch.clamp(u, 0, width - 1)
    vc = torch.clamp(v, 0, height - 1)
    r_eff = r - torch.maximum(torch.abs(u - uc), torch.abs(v - vc))
    ok = mask & in_reach & (r_eff >= 0)

    flat = (vc * width + uc).to(torch.int64)
    stamp = torch.where(ok, r_eff + 1, 0)  # 0 = empty, k = radius k-1
    lead = stamp.shape[:-1]
    stamp = stamp.reshape(-1, stamp.shape[-1])
    rmap = torch.zeros((stamp.shape[0], height * width), dtype=torch.int32, device=xyz.device)
    rmap.scatter_reduce_(1, flat.expand_as(stamp), stamp, "amax")
    rmap = rmap.reshape(-1, 1, height, width)

    acc = (rmap >= _R_MAX + 1).to(torch.float32)
    for rr in range(_R_MAX - 1, -1, -1):
        acc = torch.maximum(F.max_pool2d(acc, 3, stride=1, padding=1),
                            (rmap >= rr + 1).to(torch.float32))
    mask_img = (acc > 0.5).reshape(lead + (height, width))
    image = torch.where(mask_img, gray.to(torch.uint8), 0).to(torch.uint8)
    return image, mask_img


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
