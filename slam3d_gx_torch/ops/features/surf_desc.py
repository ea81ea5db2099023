"""SURF-64 descriptor and sliding-window orientation on arbitrary keypoints
(counterpart of slam3d_gx_tpu/ops/features/surf_desc.py).

cv::SURF's non-extended descriptor (DescriptorExtractor::create("SURF"),
reference src/GraphicEnd.cpp:65): per keypoint a 20s x 20s window in
the keypoint's orientation, split into 4x4 subregions; each gives
(sum dx, sum |dx|, sum dy, sum |dy|) of Gaussian-weighted (sigma 3.3s)
responses rotated into that orientation; the 64-vector is unit norm.
The orientation is the pi/3 sliding window, over 36 centers, of the
Gaussian-weighted (sigma 2.5s) responses within radius 6s with the
largest resultant.

Like the JAX package, it reads the responses off the smoothed Sobel maps
of the SIFT descriptor's fixed 32x32 window (sift_desc._patch_data). The
36 windows and the 16 subregions are each one masked reduction over all
keypoints.
"""

from __future__ import annotations

import math

import torch

from .common import Keypoints
from .sift_desc import _mod, _patch_data

D_SUB = 4         # subregions per axis
UNITS = 20.0      # descriptor window span in units of s
DESC_SIGMA = 3.3  # Gaussian weight over the window, units of s
ORI_SIGMA = 2.5   # orientation weight sigma, units of s
ORI_RADIUS = 6.0  # orientation support radius, units of s
ORI_WINDOWS = 36  # sliding-window centers, 10 degrees apart
ORI_HALF = math.pi / 6  # half-width of the pi/3 window


def _unit_scale(size: torch.Tensor) -> torch.Tensor:
    """SURF scale s from the keypoint diameter 6s, floored at 1/3 px."""
    return torch.clamp(size / 6.0, min=1.0 / 3.0)


def _window_centers(device) -> torch.Tensor:
    """The 36 window centers -pi + 2*pi*k/36, rounded to f32 (within one
    ulp of the JAX package's jnp.linspace)."""
    k = torch.arange(ORI_WINDOWS, dtype=torch.float64, device=device)
    return (k * (2 * math.pi / ORI_WINDOWS) - math.pi).to(torch.float32)


def _orientation(mag, ori, rx, ry, s):
    """SURF's dominant orientation (SURF paper §3.2): (K, P^2) window
    data, s (K,) -> (K,) angles."""
    sig = ORI_SIGMA * s
    r2 = rx * rx + ry * ry
    w = torch.exp(-r2 / (2.0 * (sig * sig)[:, None]))
    w = torch.where(r2 <= ((ORI_RADIUS * s) ** 2)[:, None], w, 0.0)
    v = torch.stack([mag * torch.cos(ori) * w, mag * torch.sin(ori) * w], dim=-1)  # (K,P^2,2)

    centers = _window_centers(ori.device)
    d = torch.abs(_mod(ori[:, None, :] - centers[None, :, None] + math.pi, 2 * math.pi)
                  - math.pi)
    sums = torch.bmm((d < ORI_HALF).to(v.dtype), v)  # (K,36,2)
    best = torch.argmax(sums[..., 0] * sums[..., 0] + sums[..., 1] * sums[..., 1], dim=1)
    b = torch.gather(sums, 1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    return torch.atan2(b[:, 1], b[:, 0])


def _descriptors(gdx, gdy, rx, ry, s, angles):
    """(K,64) SURF vectors from (K, P^2) response windows; s, angles (K,)."""
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    inv_s = (1.0 / s)[:, None]
    # window coordinates in the rotated frame, units of s
    u = (rx * ca + ry * sa) * inv_s
    v = (-rx * sa + ry * ca) * inv_s
    g = torch.exp(-(u * u + v * v) / (2.0 * DESC_SIGMA**2))
    dxr = (gdx * ca + gdy * sa) * g
    dyr = (-gdx * sa + gdy * ca) * g

    half, sub = UNITS / 2.0, UNITS / D_SUB
    lo = (torch.arange(D_SUB, dtype=u.dtype, device=u.device) * sub - half)[None, :, None]
    in_u = (u[:, None, :] >= lo) & (u[:, None, :] < lo + sub)  # (K,4,P^2)
    in_v = (v[:, None, :] >= lo) & (v[:, None, :] < lo + sub)
    cells = (in_v[:, :, None] & in_u[:, None, :]).reshape(u.shape[0], D_SUB * D_SUB, -1)
    resp = torch.stack([dxr, torch.abs(dxr), dyr, torch.abs(dyr)], dim=-1)  # (K,P^2,4)
    desc = torch.bmm(cells.to(resp.dtype), resp).reshape(u.shape[0], -1)  # (v,u) row-major
    return desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12)


def surf_descriptors(img: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """(K,64) float32 unit-norm SURF descriptors; invalid keypoints zero."""
    mag, ori, rx, ry = _patch_data(img, kps)
    s = _unit_scale(kps.size)
    angles = _orientation(mag, ori, rx, ry, s)
    desc = _descriptors(mag * torch.cos(ori), mag * torch.sin(ori), rx, ry, s, angles)
    return torch.where(kps.valid[:, None], desc, 0.0)
