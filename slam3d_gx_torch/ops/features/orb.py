"""ORB's rotated-BRIEF descriptor (counterpart of slam3d_gx_tpu/ops/features/orb.py).

cv::ORB as the reference's factories create it: keypoints from the grid
FAST detector (fast.py), the orientation from the intensity centroid
over a radius-15 circle (IC_Angle, atan2(m01, m10)), and 256 pairwise
intensity tests on a blurred image with the test pattern rotated by the
orientation.

The test pattern is the JAX package's own, drawn by the same seeded
numpy generator (Gaussian pairs, sigma = patch/5), so the bits are the
JAX package's; neither is OpenCV's learned table. The rotation is cut to
30 bins of 12 degrees, and each bin's 512 nearest-pixel taps are a
table of patch indices, gathered directly. Bits are 0/1 floats, so the
L2 matcher computes sqrt(Hamming).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .common import Keypoints, gaussian_blur
from .sift_desc import _mod

PATCH = 32          # sampling patch side (covers OpenCV's 31x31)
HALF = PATCH // 2
N_BITS = 256
N_BINS = 30         # orientation bins of 12 degrees
ORI_RADIUS = 15     # intensity-centroid radius


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(512, 2) test-point offsets (pairs are rows 2i, 2i+1), clipped to
    the patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(2 * N_BITS, 2))
    return np.clip(pts, -(HALF - 2), HALF - 3)


_PATTERN = _make_pattern()


def _tap_table() -> np.ndarray:
    """(N_BINS, 512) flat patch index of each pattern point rotated by
    each bin's angle, rounded to the nearest pixel."""
    table = np.zeros((N_BINS, 2 * N_BITS), np.int64)
    for b in range(N_BINS):
        a = 2 * np.pi * b / N_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = ca * _PATTERN[:, 0] - sa * _PATTERN[:, 1]
        ry = sa * _PATTERN[:, 0] + ca * _PATTERN[:, 1]
        ix = np.clip(np.round(rx).astype(int) + HALF, 0, PATCH - 1)
        iy = np.clip(np.round(ry).astype(int) + HALF, 0, PATCH - 1)
        table[b] = iy * PATCH + ix
    return table


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """The tap table and the centroid's masked offsets, copied to `device`
    once."""
    yy, xx = np.mgrid[0:PATCH, 0:PATCH]
    circ = ((xx - HALF) ** 2 + (yy - HALF) ** 2) <= ORI_RADIUS**2
    return (torch.from_numpy(_tap_table()).to(device),
            torch.from_numpy(circ.astype(np.float32)).to(device),
            torch.from_numpy((xx - HALF).astype(np.float32)).to(device),
            torch.from_numpy((yy - HALF).astype(np.float32)).to(device))


def _extract_patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(K, PATCH, PATCH) windows at the rounded keypoints, corners clamped
    into the image."""
    H, W = img.shape
    u0 = torch.clamp(torch.round(uv[:, 0]).to(torch.int64) - HALF, 0, W - PATCH)
    v0 = torch.clamp(torch.round(uv[:, 1]).to(torch.int64) - HALF, 0, H - PATCH)
    lin = torch.arange(PATCH, device=img.device)
    return img[(v0[:, None] + lin)[:, :, None], (u0[:, None] + lin)[:, None, :]]


def orientation_bins(patches: torch.Tensor) -> torch.Tensor:
    """(K,P,P) patches -> (K,) bin of the intensity-centroid angle
    (IC_Angle, atan2(m01, m10))."""
    _, circ, off_x, off_y = _constants(patches.device)
    w = patches * circ
    m10 = torch.sum(w * off_x, dim=(1, 2))
    m01 = torch.sum(w * off_y, dim=(1, 2))
    two_pi = 2 * math.pi
    angle = _mod(torch.atan2(m01, m10), two_pi)
    return torch.round(angle / two_pi * N_BINS).to(torch.int64) % N_BINS


def orb_descriptors(img: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """(K, 256) float32 descriptors with values in {0,1}. Invalid
    keypoints get zeros."""
    table = _constants(img.device)[0]
    patches = _extract_patches(gaussian_blur(img.to(torch.float32), 2.0), kps.uv)
    # rotated BRIEF: the taps of each patch's orientation bin
    sel = torch.gather(patches.reshape(-1, PATCH * PATCH), 1, table[orientation_bins(patches)])
    bits = (sel[:, 0::2] < sel[:, 1::2]).to(torch.float32)
    return torch.where(kps.valid[:, None], bits, 0.0)
