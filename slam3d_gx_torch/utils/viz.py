"""Headless visualization primitives, numpy only (counterpart of
slam3d_gx_tpu/utils/viz.py).

The reference's debug UI is imshow/drawMatches windows
(src/GraphicEnd.cpp:626-642, src/exp1/exp1.cpp:388,580,678-682); here the
same artifacts are PNGs: side-by-side match images with lines, and
per-plane coverage images.
"""

from __future__ import annotations

import numpy as np


def side_by_side(a: np.ndarray, b: np.ndarray):
    """Stack two grayscale frames horizontally; returns (canvas, x_off)."""
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1]), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    return canvas, a.shape[1]


def draw_line(img: np.ndarray, p0, p1, value: int = 255):
    """Draw a 1px line by dense sampling (in-place)."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.clip(np.round(np.linspace(x0, x1, n)).astype(int), 0,
                 img.shape[1] - 1)
    ys = np.clip(np.round(np.linspace(y0, y1, n)).astype(int), 0,
                 img.shape[0] - 1)
    img[ys, xs] = value


def draw_marker(img: np.ndarray, p, value: int = 255, r: int = 2):
    """Small filled square marker (in-place)."""
    x, y = int(round(float(p[0]))), int(round(float(p[1])))
    y0, y1 = max(0, y - r), min(img.shape[0], y + r + 1)
    x0, x1 = max(0, x - r), min(img.shape[1], x + r + 1)
    img[y0:y1, x0:x1] = value


def draw_matches(gray_a: np.ndarray, uv_a: np.ndarray,
                 gray_b: np.ndarray, uv_b: np.ndarray,
                 pairs: np.ndarray) -> np.ndarray:
    """cv::drawMatches analog: side-by-side frames, a line per match.

    pairs: (M,2) int array of (index into uv_a, index into uv_b).
    """
    canvas, off = side_by_side(gray_a, gray_b)
    for ia, ib in np.asarray(pairs, int):
        pa = uv_a[ia]
        pb = uv_b[ib] + np.array([off, 0.0])
        draw_marker(canvas, pa)
        draw_marker(canvas, pb)
        draw_line(canvas, pa, pb)
    return canvas
