"""Host-side PNG decode: 8-bit gray, 16-bit depth, color.

Parity target: cv::imread as used by the reference —
imread(path, 0) 8-bit grayscale (reference src/GraphicEnd.cpp:271),
imread(path, -1) unchanged 16-bit depth (src/GraphicEnd.cpp:276),
imread(path, CV_LOAD_IMAGE_COLOR) (src/convert2PCD.cpp:50).

Grayscale conversion follows OpenCV's BT.601 weights with rounding
(PIL's 'L' mode truncates, which would shift feature responses). Gray
and depth frames are decoded by the native codec (native_io.py,
native/png_codec.cc) when its library is built, and by PIL otherwise or
for encodings the codec does not take.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _native():
    """The native decoder when its library is built; None otherwise."""
    from .. import native_io
    return native_io if native_io.available() else None


def load_gray(path: str) -> np.ndarray:
    """8-bit grayscale (H,W) uint8, BT.601 rounding like cv::imread(.,0)."""
    nat = _native()
    if nat is not None:
        try:
            out = nat.png_decode(path, to_gray=True)
            if out.dtype == np.uint8 and out.ndim == 2:
                return out
        except ValueError:
            pass  # an encoding the codec does not take: PIL below
    return read_gray_pil(path)


def read_gray_pil(path: str) -> np.ndarray:
    """load_gray through PIL alone."""
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
    nat = _native()
    if nat is not None:
        try:
            out = nat.png_decode(path, to_gray=False)
            if out.ndim == 2:
                return out.astype(np.uint16, copy=False)
        except ValueError:
            pass
    return read_depth_pil(path)


def read_depth_pil(path: str) -> np.ndarray:
    """load_depth through PIL alone."""
    return np.asarray(Image.open(path)).astype(np.uint16)


def load_color(path: str) -> np.ndarray:
    """(H,W,3) uint8 RGB."""
    return np.asarray(Image.open(path).convert("RGB"))


def save_gray(path: str, arr: np.ndarray) -> None:
    Image.fromarray(np.asarray(arr, dtype=np.uint8), mode="L").save(path)


def save_depth(path: str, arr: np.ndarray) -> None:
    Image.fromarray(np.asarray(arr, dtype=np.uint16)).save(path)


def save_color(path: str, arr: np.ndarray) -> None:
    Image.fromarray(np.asarray(arr, dtype=np.uint8), mode="RGB").save(path)
