"""DoG (SIFT) keypoint detector (counterpart of slam3d_gx_tpu/ops/features/dog.py).

cv::SIFT detection as the reference configures it: difference-of-Gaussian
extrema over octaves, contrast threshold 0.04, edge-ratio threshold 10,
nOctaveLayers=3, sigma=1.6. The pyramid numerics are the reference's
fan-out form (every level blurred from the octave base with the composed
relative sigma), so both packages see the same scale space. Candidates
are the top `max_kp` per octave by |DoG|, then the global top `max_kp`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .common import Keypoints, _edge_pad, gaussian_blur

N_LAYERS = 3          # nOctaveLayers
SIGMA0 = 1.6
INIT_BLUR = 0.5       # assumed camera blur
CONTRAST_THR = 0.04
EDGE_THR = 10.0


def _octave_taps(n_imgs: int):
    """(radius, (L, taps) fp32 weights): row i blurs the octave base to
    total sigma SIGMA0 * 2^(i/N_LAYERS); row 0 is the identity."""
    k2 = 2.0 ** (2.0 / N_LAYERS)
    rel = [(SIGMA0**2 * (k2**i - 1.0)) ** 0.5 for i in range(n_imgs)]
    radius = max(1, int(round(3.0 * rel[-1])))
    taps = 2 * radius + 1
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    rows = [torch.zeros(taps, dtype=torch.float32)]
    rows[0][radius] = 1.0
    for s in rel[1:]:
        r = torch.exp(-0.5 * (x / s) ** 2)
        rows.append(r / r.sum())
    return radius, torch.stack(rows)


@functools.lru_cache(maxsize=None)
def _octave_weights(n_imgs: int, device: str):
    radius, w = _octave_taps(n_imgs)
    return radius, w.to(device)[:, :, None, None]  # (L,taps,1,1)


def _octave_gaussians(base: torch.Tensor, n_imgs: int) -> torch.Tensor:
    """(H,W) octave base -> (L,H,W) Gaussian stack, one fused
    weighted-shift pass per direction."""
    radius, w = _octave_weights(n_imgs, str(base.device))
    taps = 2 * radius + 1
    H, W = base.shape
    pad = _edge_pad(base, radius, radius, 0, 0)
    stack = torch.zeros((n_imgs, H, W), dtype=base.dtype, device=base.device)
    for t in range(taps):
        stack = stack + w[:, t] * pad[None, t:t + H, :]
    pad = _edge_pad(stack, 0, 0, radius, radius)
    out = torch.zeros((n_imgs, H, W), dtype=base.dtype, device=base.device)
    for t in range(taps):
        out = out + w[:, t] * pad[:, :, t:t + W]
    return out


def _extrema_mask(dog: torch.Tensor) -> torch.Tensor:
    """dog (L,h,w) -> True where a voxel is a 3x3x3 max or min."""
    x = dog[None, None]
    big = F.max_pool3d(x, 3, stride=1, padding=1)[0, 0]
    small = -F.max_pool3d(-x, 3, stride=1, padding=1)[0, 0]
    return (dog >= big) | (dog <= small)


def _hessian2(layer: torch.Tensor):
    """Interior finite-difference dxx, dyy, dxy of an (h,w) layer."""
    c = layer[1:-1, 1:-1]
    dxx = layer[1:-1, 2:] + layer[1:-1, :-2] - 2 * c
    dyy = layer[2:, 1:-1] + layer[:-2, 1:-1] - 2 * c
    dxy = (layer[2:, 2:] - layer[2:, :-2] - layer[:-2, 2:] + layer[:-2, :-2]) * 0.25
    return dxx, dyy, dxy


def _edge_ok(layer: torch.Tensor) -> torch.Tensor:
    """2D Hessian edge-ratio test on a DoG layer (False on the border)."""
    dxx, dyy, dxy = _hessian2(layer)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = EDGE_THR
    ok = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)
    return F.pad(ok, (1, 1, 1, 1), value=False)


def _subpixel_shift(layer: torch.Tensor):
    """One-step 2D quadratic offset (du, dv) per pixel, clipped to 0.5."""
    dx = (layer[1:-1, 2:] - layer[1:-1, :-2]) * 0.5
    dy = (layer[2:, 1:-1] - layer[:-2, 1:-1]) * 0.5
    dxx, dyy, dxy = _hessian2(layer)
    det = dxx * dyy - dxy * dxy
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    du = torch.clamp(-(dyy * dx - dxy * dy) / det, -0.5, 0.5)
    dv = torch.clamp(-(-dxy * dx + dxx * dy) / det, -0.5, 0.5)
    return F.pad(du, (1, 1, 1, 1)), F.pad(dv, (1, 1, 1, 1))


def detect_sift(img: torch.Tensor, max_kp: int = 512, n_octaves: int = 4) -> Keypoints:
    """img: (H,W) uint8/float. Fixed-capacity SIFT keypoints."""
    x = img.to(torch.float32) / 255.0
    # lift the base blur to SIGMA0 (no initial doubling)
    base = gaussian_blur(x, max(SIGMA0**2 - INIT_BLUR**2, 0.01) ** 0.5)
    thr = 0.5 * CONTRAST_THR / N_LAYERS
    octaves = []
    for o in range(n_octaves):
        gs = _octave_gaussians(base, N_LAYERS + 3)
        dog = gs[1:] - gs[:-1]  # (L+2,h,w)
        ext = _extrema_mask(dog)
        h, w = dog.shape[1:]
        layers = range(1, N_LAYERS + 1)
        resp = torch.stack([
            torch.where(ext[l] & (torch.abs(dog[l]) > thr) & _edge_ok(dog[l]),
                        torch.abs(dog[l]), -torch.inf)
            for l in layers])  # (L,h,w)
        inside = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        inside[4:h - 4, 4:w - 4] = True
        resp = torch.where(inside, resp, -torch.inf)

        vals, idx = torch.topk(resp.reshape(-1), max_kp)
        layer_i = idx // (h * w)
        vi = (idx % (h * w)) // w
        ui = idx % w
        valid = vals > 0.0
        shifts = [_subpixel_shift(dog[l]) for l in layers]
        du = torch.stack([s[0] for s in shifts])[layer_i, vi, ui]
        dv = torch.stack([s[1] for s in shifts])[layer_i, vi, ui]
        scale = float(2**o)
        uv = torch.stack([ui.to(torch.float32) + du, vi.to(torch.float32) + dv], -1)
        sigma = SIGMA0 * (2.0 ** ((layer_i.to(torch.float32) + 1.0) / N_LAYERS)) * scale
        octaves.append(Keypoints(
            uv=uv * scale,
            response=torch.where(valid, vals, 0.0),
            size=2.0 * sigma,
            angle=torch.zeros_like(vals),
            valid=valid,
        ))
        # next octave: downsample the Gaussian image with sigma 2*SIGMA0
        base = gs[N_LAYERS][::2, ::2]

    merged = Keypoints(*(torch.cat(f) for f in zip(*octaves)))
    score = torch.where(merged.valid, merged.response, -torch.inf)
    return merged.take(torch.topk(score, max_kp).indices)
