"""ctypes bindings of the native host I/O in native/*.cc
(counterpart of slam3d_gx_tpu/native_io.py).

The C++ layer is the host's data path: PNG decode (the dataset's gray
and 16-bit depth frames), the PCD reader, and a threaded loader that
decodes the frames ahead in order while the device works. The PCD
writer stays io/pcd.write_pcd: native/ has none.

The library is built at first use with g++ from the repo's native/
sources (`g++ -O3 -fPIC -std=c++17 -shared ... -lz -lpthread`) into
slam3d_gx_torch/_build/, under a file name keyed on a hash of the
sources and the flags, so an edited source is built anew. Without a
compiler or zlib, `available()` is False and the callers read in
Python (io/images.py, io/pcd.py): this is host I/O only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("png_codec.cc", "pcd_codec.cc", "loader.cc")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LD_FLAGS = ["-lz", "-lpthread"]

MODE_GRAY8 = 0
MODE_DEPTH16 = 1
MODE_PCD = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is not available, when it is not
build_error: Optional[str] = None


def lib_path() -> str:
    """Where the library of the current sources and flags is built."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(f.read() + b"\0")
    h.update("\0".join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libslam3d_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path, raises
    RuntimeError when g++ fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, *(os.path.join(NATIVE_DIR, s) for s in SOURCES),
           "-o", tmp, *LD_FLAGS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders each write their own tmp
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
        except (RuntimeError, OSError) as e:
            build_error = str(e)
            return None
        lib.slam3d_png_info.restype = ctypes.c_int
        lib.slam3d_png_decode.restype = ctypes.c_int
        lib.slam3d_pcd_points.restype = ctypes.c_int64
        lib.slam3d_pcd_read.restype = ctypes.c_int64
        lib.slam3d_loader_create.restype = ctypes.c_void_p
        lib.slam3d_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.slam3d_loader_next.restype = ctypes.c_int64
        lib.slam3d_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.slam3d_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {build_error}")
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def png_decode(path: str, to_gray: bool = True) -> np.ndarray:
    """Decode a PNG file: uint8 (H,W) or (H,W,C), or uint16 (H,W) for
    16-bit images. to_gray turns 8-bit colour into BT.601 gray with
    rounding, as cv::imread(path, 0)."""
    lib = _require()
    data = np.fromfile(path, dtype=np.uint8)
    w, h, ch, bd = (ctypes.c_uint32() for _ in range(4))
    if lib.slam3d_png_info(_u8(data), ctypes.c_int64(data.size), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(ch), ctypes.byref(bd)) != 0:
        raise ValueError(f"bad png: {path}")
    H, W, C, B = h.value, w.value, ch.value, bd.value
    gray = to_gray and C >= 3
    if B == 16:
        out = np.empty((H, W * C), np.uint16)
    else:
        out = np.empty((H, W) if gray else (H, W * C), np.uint8)
    rc = lib.slam3d_png_decode(_u8(data), ctypes.c_int64(data.size),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               ctypes.c_int(1 if gray and B == 8 else 0))
    if rc != 0:
        raise ValueError(f"png decode failed ({rc}): {path}")
    if C == 1 or (gray and B == 8):
        return out.reshape(H, W)
    return out.reshape(H, W, C)


def pcd_read(path: str):
    """Read a PCD file -> (xyz float32 (N,3), rgba uint32 (N,))."""
    lib = _require()
    data = np.fromfile(path, dtype=np.uint8)
    n = lib.slam3d_pcd_points(_u8(data), ctypes.c_int64(data.size))
    if n < 0:
        raise ValueError(f"bad pcd: {path}")
    xyz = np.empty((n, 3), np.float32)
    rgba = np.empty((n,), np.uint32)
    rc = lib.slam3d_pcd_read(_u8(data), ctypes.c_int64(data.size),
                             xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != n:
        raise ValueError(f"pcd read failed ({rc}): {path}")
    return xyz, rgba


class PrefetchLoader:
    """In-order threaded prefetch over a list of files of one kind.

    mode: MODE_GRAY8 (uint8 HxW), MODE_DEPTH16 (uint16 HxW), MODE_PCD
    (float32 (N,3) and uint32 (N,)). next() returns the decoded item,
    None when that file could not be decoded, and raises StopIteration
    after the last."""

    def __init__(self, paths: List[str], mode: int, height: int = 0, width: int = 0,
                 max_points: int = 1 << 19, queue_depth: int = 4, threads: int = 2):
        lib = _require()
        self._lib = lib
        self.mode = mode
        self.h, self.w = height, width
        if mode == MODE_PCD:
            self.item_bytes = max_points * 16
        elif mode == MODE_DEPTH16:
            self.item_bytes = height * width * 2
        else:
            self.item_bytes = height * width
        blob = b"\0".join(p.encode() for p in paths) + b"\0"
        self._n = len(paths)
        self._consumed = 0
        self._buf = np.empty((self.item_bytes,), np.uint8)
        self._handle = lib.slam3d_loader_create(
            blob, len(blob), len(paths), mode, self.item_bytes, queue_depth, threads,
            width, height)

    def next(self):
        if self._consumed >= self._n:
            raise StopIteration
        payload = self._lib.slam3d_loader_next(self._handle,
                                               self._buf.ctypes.data_as(ctypes.c_void_p))
        self._consumed += 1
        if payload == -1:
            raise StopIteration
        if payload < 0:
            return None
        if self.mode == MODE_PCD:
            n = int(payload)
            return (self._buf[: n * 12].view(np.float32).reshape(n, 3).copy(),
                    self._buf[n * 12: n * 16].view(np.uint32).copy())
        if self.mode == MODE_DEPTH16:
            return self._buf[: self.h * self.w * 2].view(np.uint16).reshape(self.h, self.w).copy()
        return self._buf[: self.h * self.w].reshape(self.h, self.w).copy()

    def close(self):
        if self._handle:
            self._lib.slam3d_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
