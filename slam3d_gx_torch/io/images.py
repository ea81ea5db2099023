"""Host-side PNG decode: 8-bit gray, 16-bit depth, color.

Parity target: cv::imread as used by the reference —
imread(path, 0) 8-bit grayscale (reference src/GraphicEnd.cpp:271),
imread(path, -1) unchanged 16-bit depth (src/GraphicEnd.cpp:276),
imread(path, CV_LOAD_IMAGE_COLOR) (src/convert2PCD.cpp:50).

Grayscale conversion follows OpenCV's BT.601 weights with rounding
(PIL's 'L' mode truncates, which would shift feature responses).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_gray(path: str) -> np.ndarray:
    """8-bit grayscale (H,W) uint8, BT.601 rounding like cv::imread(.,0)."""
    img = Image.open(path)
    if img.mode in ("L", "I;16", "I"):
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr
    rgb = np.asarray(img.convert("RGB"), dtype=np.float32)
    gray = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    return np.clip(np.round(gray), 0, 255).astype(np.uint8)


def load_depth(path: str) -> np.ndarray:
    """16-bit depth (H,W) uint16, raw values (cv::imread(.,-1))."""
    img = Image.open(path)
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr.astype(np.uint16)
    return arr.astype(np.uint16)


def load_color(path: str) -> np.ndarray:
    """(H,W,3) uint8 RGB."""
    return np.asarray(Image.open(path).convert("RGB"))


def save_gray(path: str, arr: np.ndarray) -> None:
    Image.fromarray(np.asarray(arr, dtype=np.uint8), mode="L").save(path)


def save_depth(path: str, arr: np.ndarray) -> None:
    Image.fromarray(np.asarray(arr, dtype=np.uint16)).save(path)


def save_color(path: str, arr: np.ndarray) -> None:
    Image.fromarray(np.asarray(arr, dtype=np.uint8), mode="RGB").save(path)
