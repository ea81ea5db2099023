"""SIFT descriptor + orientation assignment on arbitrary keypoints
(counterpart of slam3d_gx_tpu/ops/features/sift_desc.py).

cv::SIFT's conventions, which shape the match distances downstream:
4x4 spatial bins x 8 orientations, Gaussian window, 0.2 clipping,
renormalize, scale by 512 and saturate to [0,255]. Each keypoint reads
a fixed 32x32 window of the global gradient maps around it; every weight
(rotated spatial trilinear, Gaussian window, orientation hat) is computed
from the window coordinates, and the (spatial x orientation) histogram
is one batched matrix product.
"""

from __future__ import annotations

import functools
import math

import torch

from .common import Keypoints, gaussian_blur, sobel_gradients

D = 4        # spatial bins per axis
NBINS = 8    # orientation bins
SCL_FCTR = 3.0  # bin width = SCL_FCTR * scl (OpenCV SIFT_DESCR_SCL_FCTR)
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS_BINS = 3.0  # radius = 3 * 1.5 * scl
PATCH = 32   # window side; pixels beyond it carry ~zero Gaussian weight


def _mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """Floor modulo with jnp.mod's arithmetic (fmod, then shift by m)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _patch_data(img: torch.Tensor, kps: Keypoints):
    """Gradient magnitude/orientation and offsets of every window pixel
    relative to its (float) keypoint, each (K, PATCH*PATCH)."""
    dx, dy = sobel_gradients(gaussian_blur(img.to(torch.float32), 1.6))
    H, W = img.shape
    # top-left integer corners, clamped so the window stays in bounds
    u0 = torch.clamp(torch.round(kps.uv[:, 0]).to(torch.int64) - PATCH // 2, 0, W - PATCH)
    v0 = torch.clamp(torch.round(kps.uv[:, 1]).to(torch.int64) - PATCH // 2, 0, H - PATCH)
    lin = torch.arange(PATCH, device=img.device)
    rows = (v0[:, None] + lin)[:, :, None]  # (K,P,1)
    cols = (u0[:, None] + lin)[:, None, :]  # (K,1,P)
    gdx = dx[rows, cols].reshape(-1, PATCH * PATCH)
    gdy = dy[rows, cols].reshape(-1, PATCH * PATCH)
    linf = lin.to(torch.float32)
    rx = (u0[:, None].to(torch.float32) + linf) - kps.uv[:, 0:1]  # (K,P) by col
    ry = (v0[:, None].to(torch.float32) + linf) - kps.uv[:, 1:2]  # (K,P) by row
    K = kps.uv.shape[0]
    rx = rx[:, None, :].expand(K, PATCH, PATCH).reshape(K, -1)
    ry = ry[:, :, None].expand(K, PATCH, PATCH).reshape(K, -1)
    mag = torch.sqrt(gdx * gdx + gdy * gdy)
    ori = torch.atan2(gdy, gdx)  # [-pi, pi]
    return mag, ori, rx, ry


@functools.lru_cache(maxsize=None)
def _smoothing_taps(device: torch.device) -> torch.Tensor:
    """[1,4,6,4,1]/16 on `device`, copied there once: a copy from the
    host waits for the stream."""
    return torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=device) / 16.0


def _orientations(mag, ori, rx, ry, size):
    """cv::SIFT calcOrientationHist on the window: 36-bin Gaussian-weighted
    histogram within radius 3*1.5*scl, circular smoothing, parabolic peak."""
    scl = 0.5 * size
    sig = ORI_SIG_FCTR * scl
    radius = ORI_RADIUS_BINS * sig
    r2 = rx * rx + ry * ry
    w = torch.exp(-r2 / (2.0 * (sig * sig)[:, None]))
    w = torch.where(r2 <= (radius * radius)[:, None], w, 0.0)
    mw = mag * w

    binf = (ori + math.pi) / (2 * math.pi) * ORI_BINS  # [0, 36]
    bins = torch.arange(ORI_BINS, dtype=torch.float32, device=mag.device)
    d = torch.abs(_mod(binf[..., None] - bins + ORI_BINS / 2, ORI_BINS) - ORI_BINS / 2)
    hist = torch.sum(mw[..., None] * torch.clamp(1.0 - d, min=0.0), dim=1)  # (K,36)

    # circular [1,4,6,4,1]/16 smoothing
    k = _smoothing_taps(mag.device)
    idx = (torch.arange(ORI_BINS, device=mag.device)[:, None]
           + torch.arange(-2, 3, device=mag.device)[None, :]) % ORI_BINS
    hist = torch.sum(hist[:, idx] * k, dim=2)

    peak = torch.argmax(hist, dim=1)

    def at(off):
        return torch.gather(hist, 1, ((peak + off) % ORI_BINS)[:, None])[:, 0]

    l, c, r = at(-1), at(0), at(1)
    denom = l - 2 * c + r
    off = torch.where(torch.abs(denom) > 1e-9, 0.5 * (l - r) / denom, 0.0)
    off = torch.clamp(off, -0.5, 0.5)
    return (peak.to(torch.float32) + off + 0.5) / ORI_BINS * 2 * math.pi - math.pi


def _descriptors(mag, ori, rx, ry, size, angles):
    """cv::SIFT calcSIFTDescriptor, batched over keypoints."""
    hist_width = SCL_FCTR * 0.5 * size  # (K,) pixels per spatial bin
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    inv_hw = (1.0 / hist_width)[:, None]

    # rotate offsets into the descriptor frame, in bin units
    cbin = (rx * ca + ry * sa) * inv_hw + (D / 2 - 0.5)
    rbin = (-rx * sa + ry * ca) * inv_hw + (D / 2 - 0.5)

    # Gaussian window over the descriptor (sigma = 0.5*D bins)
    gx = cbin - (D / 2 - 0.5)
    gy = rbin - (D / 2 - 0.5)
    mw = mag * torch.exp(-(gx * gx + gy * gy) / (2 * (0.5 * D) ** 2))  # (K,P^2)

    # orientation hats (K,P^2,8)
    obinf = _mod((ori - angles[:, None]) / (2 * math.pi) * NBINS, NBINS)
    obins = torch.arange(NBINS, dtype=torch.float32, device=mag.device)
    d = torch.abs(_mod(obinf[..., None] - obins + NBINS / 2, NBINS) - NBINS / 2)
    wo = torch.clamp(1.0 - d, min=0.0)

    # spatial trilinear hats (K,16,P^2), layout (by,bx)
    sb = torch.arange(D, dtype=torch.float32, device=mag.device)
    wr = torch.clamp(1.0 - torch.abs(rbin[:, None, :] - sb[None, :, None]), min=0.0)
    wc = torch.clamp(1.0 - torch.abs(cbin[:, None, :] - sb[None, :, None]), min=0.0)
    ws = (wr[:, :, None, :] * mw[:, None, None, :] * wc[:, None, :, :]).reshape(
        mag.shape[0], D * D, -1)
    desc = torch.bmm(ws, wo).reshape(mag.shape[0], D * D * NBINS)  # (by,bx,o)

    # OpenCV post-processing: L2 -> clip 0.2 -> L2 -> 512x saturate
    n = torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12
    desc = torch.clamp(desc / n, 0.0, 0.2)
    n = torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12
    return torch.clamp(torch.round(desc / n * 512.0), 0.0, 255.0)


def sift_descriptors(img: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """(K,128) float32 descriptors (OpenCV value convention: 512x,
    saturated). Invalid keypoints get zero descriptors."""
    mag, ori, rx, ry = _patch_data(img, kps)
    angles = _orientations(mag, ori, rx, ry, kps.size)
    desc = _descriptors(mag, ori, rx, ry, kps.size, angles)
    return torch.where(kps.valid[:, None], desc, 0.0)
