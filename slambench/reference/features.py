"""Plain PyTorch reference of the extraction: the GFTT keypoint set, the
SIFT descriptor at given keypoints, and keypoint back-projection.

Written from OpenCV's definitions (cv::GFTTDetector with qualityLevel
0.01, blockSize 3, minDistance 1; cv::SIFT's calcOrientationHist and
calcSIFTDescriptor; the reference's compute3dPosition) in the variant the
configuration runs: gradients of a 3x3 Sobel with replicated edges, the
descriptor over a 32x32 window of the sigma-1.6-blurred image. No
kernels, no batching tricks: shifts, sums and explicit loops. `dtype`
sets the arithmetic's precision: float32 is the reference, bfloat16 the
control. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def _pad_edge(x: torch.Tensor, r: int) -> torch.Tensor:
    H, W = x.shape
    rows = torch.clamp(torch.arange(-r, H + r, device=x.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-r, W + r, device=x.device), 0, W - 1)
    return x[rows][:, cols]


def _shift(xp: torch.Tensor, r: int, dy: int, dx: int, H: int, W: int) -> torch.Tensor:
    """x[y+dy, x+dx] of the image that `xp` pads by r."""
    return xp[r + dy:r + dy + H, r + dx:r + dx + W]


def sobel(img: torch.Tensor):
    """OpenCV's 3x3 Sobel dx, dy (no scaling), replicated edges."""
    H, W = img.shape
    p = _pad_edge(img, 1)

    def s(dy, dx):
        return _shift(p, 1, dy, dx, H, W)

    dx = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)) - (s(-1, -1) + 2 * s(0, -1) + s(1, -1))
    dy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)) - (s(-1, -1) + 2 * s(-1, 0) + s(-1, 1))
    return dx, dy


def box_mean3(x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape
    p = _pad_edge(x, 1)
    acc = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + _shift(p, 1, dy, dx, H, W)
    return acc / 9


def gftt_topk(gray: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """The (k,2) (u,v) pixels of the k strongest Shi-Tomasi responses that
    are local maxima of their 3x3 neighbourhood, 2 px or more from the
    border, strongest first, equal responses in raster order."""
    img = gray.to(dtype)
    dx, dy = sobel(img)
    a, c, b = box_mean3(dx * dx), box_mean3(dy * dy), box_mean3(dx * dy)
    lam = (a + c) / 2 - torch.sqrt(((a - c) / 2) ** 2 + b * b)
    lam = torch.clamp(lam.to(torch.float32), min=0.0)
    H, W = lam.shape
    p = torch.full((H + 2, W + 2), -math.inf, device=lam.device)
    p[1:-1, 1:-1] = lam
    peak = torch.ones_like(lam, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            peak &= lam >= p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    score = torch.where(peak, lam, -math.inf)
    score[:2] = -math.inf
    score[-2:] = -math.inf
    score[:, :2] = -math.inf
    score[:, -2:] = -math.inf
    order = torch.sort(score.reshape(-1), descending=True, stable=True).indices[:k]
    return torch.stack([order % W, order // W], dim=-1)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    r = int(round(3 * sigma))
    x = torch.arange(-r, r + 1, dtype=torch.float32)
    taps = torch.exp(-0.5 * (x / sigma) ** 2)
    taps = (taps / taps.sum()).tolist()
    H, W = img.shape
    p = _pad_edge(img, r)
    col = sum(t * p[i:i + H, r:r + W] for i, t in enumerate(taps))
    p = _pad_edge(col, r)
    return sum(t * p[r:r + H, i:i + W] for i, t in enumerate(taps))


def sift_descriptors(gray: torch.Tensor, uv: torch.Tensor, size: torch.Tensor,
                     valid: torch.Tensor, dtype=torch.float32, window: int = 32) -> torch.Tensor:
    """(K,128) SIFT descriptors at keypoints uv (K,2) of diameter `size`:
    dominant orientation from a 36-bin histogram, then 4x4 spatial x 8
    orientation bins, L2-normalized, clipped at 0.2, renormalized, times
    512, rounded and saturated to [0,255]. Invalid keypoints give zeros."""
    H, W = gray.shape
    dx, dy = sobel(_blur(gray.to(torch.float32), 1.6))
    dx, dy = dx.to(dtype), dy.to(dtype)
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx)
    K = uv.shape[0]
    out = torch.zeros((K, 128), dtype=torch.float32, device=gray.device)
    half = window // 2
    lin = torch.arange(window, device=gray.device)
    u0 = torch.clamp(torch.round(uv[:, 0]).long() - half, 0, W - window)
    v0 = torch.clamp(torch.round(uv[:, 1]).long() - half, 0, H - window)
    rows = v0[:, None, None] + lin[None, :, None]
    cols = u0[:, None, None] + lin[None, None, :]
    m = mag[rows, cols].reshape(K, -1)
    o = ori[rows, cols].reshape(K, -1)
    rx = (cols.to(dtype) - uv[:, 0, None, None].to(dtype)).expand(K, window, window).reshape(K, -1)
    ry = (rows.to(dtype) - uv[:, 1, None, None].to(dtype)).expand(K, window, window).reshape(K, -1)
    scl = (0.5 * size).to(dtype)[:, None]

    # dominant orientation
    sig = 1.5 * scl
    r2 = rx * rx + ry * ry
    w = torch.where(r2 <= (3 * sig) ** 2, torch.exp(-r2 / (2 * sig * sig)), 0.0) * m
    pos = (o + math.pi) / (2 * math.pi) * 36
    hist = torch.zeros((K, 36), dtype=dtype, device=gray.device)
    for b in range(36):
        d = torch.remainder(pos - b + 18, 36) - 18
        hist[:, b] = torch.sum(w * torch.clamp(1 - d.abs(), min=0), dim=1)
    taps = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    smooth = sum(t * torch.roll(hist, 2 - i, dims=1) for i, t in enumerate(taps))
    peak = torch.argmax(smooth, dim=1)
    ar = torch.arange(K, device=gray.device)
    left, mid, right = (smooth[ar, (peak + s) % 36] for s in (-1, 0, 1))
    den = left - 2 * mid + right
    off = torch.where(den.abs() > 1e-9, 0.5 * (left - right) / den, 0.0).clamp(-0.5, 0.5)
    angle = ((peak.to(dtype) + off + 0.5) / 36 * 2 * math.pi - math.pi)[:, None]

    # descriptor
    hw = 3 * scl
    cb = (rx * torch.cos(angle) + ry * torch.sin(angle)) / hw + 1.5
    rb = (-rx * torch.sin(angle) + ry * torch.cos(angle)) / hw + 1.5
    wm = m * torch.exp(-((cb - 1.5) ** 2 + (rb - 1.5) ** 2) / 8)
    opos = torch.remainder((o - angle) / (2 * math.pi) * 8, 8)
    desc = torch.zeros((K, 4, 4, 8), dtype=dtype, device=gray.device)
    for by in range(4):
        wy = torch.clamp(1 - (rb - by).abs(), min=0)
        for bx in range(4):
            wxy = wy * torch.clamp(1 - (cb - bx).abs(), min=0) * wm
            for ob in range(8):
                d = torch.remainder(opos - ob + 4, 8) - 4
                desc[:, by, bx, ob] = torch.sum(wxy * torch.clamp(1 - d.abs(), min=0), dim=1)
    desc = desc.reshape(K, 128)
    n = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True)) + 1e-12
    desc = torch.clamp(desc / n, 0, 0.2)
    n = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True)) + 1e-12
    desc = torch.clamp(torch.round(desc / n * 512), 0, 255).to(torch.float32)
    out[valid] = desc[valid]
    return out


def backproject(depth: torch.Tensor, uv: torch.Tensor, cam: dict, dtype=torch.float64):
    """compute3dPosition: (...,K,3) camera points of keypoints uv (...,K,2)
    from the depth at the rounded pixel, in metres; where that depth is 0,
    z = 0 (the image path drops those keypoints)."""
    H, W = depth.shape
    u = torch.clamp(torch.round(uv[..., 0]).long(), 0, W - 1)
    v = torch.clamp(torch.round(uv[..., 1]).long(), 0, H - 1)
    d = depth[v, u].to(dtype)
    k1 = (uv[..., 0].to(dtype) - cam["cx"]) / cam["fx"]
    k2 = (uv[..., 1].to(dtype) - cam["cy"]) / cam["fy"]
    z = d / cam["factor"]
    return torch.stack([k1 * z, k2 * z, z], dim=-1)
