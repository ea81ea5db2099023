"""Shared feature machinery: fixed-K keypoint container, filters, NMS, top-k
(counterpart of slam3d_gx_tpu/ops/features/common.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (padded, masked).

    uv: (K,2) float32, (u=x=col, v=y=row) in OpenCV KeyPoint.pt order;
    response: (K,) float32; size: (K,) float32 (diameter, px);
    angle: (K,) float32 radians (0 when undefined); valid: (K,) bool.
    """

    uv: torch.Tensor
    response: torch.Tensor
    size: torch.Tensor
    angle: torch.Tensor
    valid: torch.Tensor

    def take(self, idx: torch.Tensor) -> "Keypoints":
        return Keypoints(*(f[idx] for f in self))


def _max_pool_same(x: torch.Tensor, w: int) -> torch.Tensor:
    """(...,H,W) max over a (w,w) window, -inf outside the image."""
    r = w // 2
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), w, stride=1, padding=r)
    return y.reshape(lead + x.shape[-2:])


def nms(response: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Keep strict local maxima within a (2r+1)^2 window."""
    pooled = _max_pool_same(response, 2 * radius + 1)
    return torch.where(response >= pooled, response, -torch.inf)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    in index order as lax.top_k takes them: torch.topk leaves their order
    to the device, so the card and the CPU would list tied keypoints (and
    draw RANSAC triplets from them) differently."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_keypoints(response, k: int, threshold=0.0, nms_radius: int = 1,
                   border: int = 0, size: float = 7.0) -> Keypoints:
    """Response map (H,W) -> top-k keypoints above threshold after NMS."""
    H, W = response.shape
    r = nms(response, nms_radius)
    if border > 0:
        inside = torch.zeros_like(r, dtype=torch.bool)
        inside[border:H - border, border:W - border] = True
        r = torch.where(inside, r, -torch.inf)
    vals, idx = top_k(r.reshape(-1), k)
    v = (idx // W).to(torch.float32)
    u = (idx % W).to(torch.float32)
    valid = vals > threshold
    return Keypoints(
        uv=torch.stack([u, v], dim=-1),
        response=torch.where(valid, vals, 0.0),
        size=torch.full((k,), size, dtype=torch.float32, device=r.device),
        angle=torch.zeros((k,), dtype=torch.float32, device=r.device),
        valid=valid,
    )


def pixel_index(uv: torch.Tensor, H: int, W: int):
    """Rounded, clamped integer pixel (u, v) of float keypoint coords."""
    u = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    return u, v


def apply_mask(kps: Keypoints, mask_img: torch.Tensor) -> Keypoints:
    """Restrict keypoints to a binary image mask (detector mask argument,
    reference src/GraphicEnd.h:105-111)."""
    u, v = pixel_index(kps.uv, *mask_img.shape)
    return kps._replace(valid=kps.valid & mask_img[v, u])


def _conv2(img: torch.Tensor, kernel) -> torch.Tensor:
    """Valid-mode 2D correlation of a small static kernel (nested lists of
    floats), as shifted multiply-adds in the reference's order."""
    kh, kw = len(kernel), len(kernel[0])
    H = img.shape[-2] - kh + 1
    W = img.shape[-1] - kw + 1
    out = torch.zeros(img.shape[:-2] + (H, W), dtype=img.dtype, device=img.device)
    for dy in range(kh):
        for dx in range(kw):
            out = out + kernel[dy][dx] * img[..., dy:dy + H, dx:dx + W]
    return out


def _edge_pad(img: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dims (jnp.pad mode="edge")."""
    H, W = img.shape[-2:]
    rows = torch.clamp(torch.arange(-top, H + bottom, device=img.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-left, W + right, device=img.device), 0, W - 1)
    return img[..., rows, :][..., cols]


_SOBEL_X = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
_SOBEL_Y = [list(r) for r in zip(*_SOBEL_X)]


def sobel_gradients(img: torch.Tensor):
    """Sobel 3x3 dx, dy (OpenCV kernel, no scaling). img float32 (H,W)."""
    pad = _edge_pad(img, 1, 1, 1, 1)
    return _conv2(pad, _SOBEL_X), _conv2(pad, _SOBEL_Y)


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean filter over (2r+1)^2, edge-padded (separable shift-add)."""
    w = 2 * radius + 1
    H, W = img.shape[-2:]
    pad = _edge_pad(img, radius, radius, 0, 0)
    s = torch.zeros_like(img)
    for dy in range(w):
        s = s + pad[..., dy:dy + H, :]
    pad = _edge_pad(s, 0, 0, radius, radius)
    s = torch.zeros_like(img)
    for dx in range(w):
        s = s + pad[..., :, dx:dx + W]
    return s / (w * w)


def gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    """Normalized fp32 Gaussian taps, computed on the host."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None):
    """Separable Gaussian blur, edge-padded (cv::GaussianBlur analog)."""
    if radius is None:
        radius = max(1, int(round(3.0 * sigma)))
    taps = gaussian_kernel1d(sigma, radius).tolist()
    img = _conv2(_edge_pad(img, radius, radius, 0, 0), [[t] for t in taps])
    return _conv2(_edge_pad(img, 0, 0, radius, radius), [taps])
