"""K1 `histogram256` and K2 `apply_lut256`: CUDA kernels for equalizeHist.

They replace the two Pallas TPU kernels on the main path
(slam3d_gx_tpu/ops/pallas_kernels.py: `_hist_kernel` behind
`histogram256`, `_lut_kernel` behind `apply_lut256`), both called once
per frame by `ops.imageproc.equalize_hist`. Sources, bounds and design
notes: csrc/equalize.cu.

Each wrapper takes the plain PyTorch version for a tensor on the CPU
and launches its kernel for a tensor on a CUDA device, or raises; it
never falls back. `LAUNCHES` counts kernel launches by name, and
nothing else adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "equalize"
LAUNCHES = {"histogram256": 0, "apply_lut256": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.slam_hist256.argtypes = [vp, ll, vp, vp]
        lib.slam_hist256.restype = ctypes.c_int
        lib.slam_lut256.argtypes = [vp, vp, vp, ll, vp]
        lib.slam_lut256.restype = ctypes.c_int
        lib._typed = True
    return lib


def _as_u8(values: torch.Tensor) -> torch.Tensor:
    """Flat contiguous uint8 view of integer-valued data in [0, 255]
    (the reference hands its kernels f32 holding such integers; the cast
    is exact for them)."""
    flat = values.reshape(-1)
    if flat.dtype != torch.uint8:
        flat = flat.to(torch.uint8)
    return flat.contiguous()


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# -- K1 ---------------------------------------------------------------------

def histogram256_plain(values: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of integer-valued data -> (256,) int32."""
    flat = values.reshape(-1).long()
    return torch.bincount(flat, minlength=256).to(torch.int32)


def histogram256(values: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of integer-valued data in [0, 255], any shape.
    -> (256,) int32 on the input's device."""
    if values.device.type == "cpu":
        return histogram256_plain(values)
    if values.device.type != "cuda":
        raise RuntimeError(f"histogram256: unsupported device {values.device}")
    x = _as_u8(values)
    out = torch.zeros(256, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().slam_hist256(
            ctypes.c_void_p(x.data_ptr()), x.numel(),
            ctypes.c_void_p(out.data_ptr()), _stream(x))
    _check(rc, "histogram256")
    LAUNCHES["histogram256"] += 1
    return out


# -- K2 ---------------------------------------------------------------------

def apply_lut256_plain(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """lut[values] cast to uint8, same shape as values."""
    return lut.to(torch.float32)[values.long()].to(torch.uint8)


def apply_lut256(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Elementwise lut[values] for integer-valued `values` in [0, 255]
    and a (256,) LUT of integers in [0, 255] -> uint8, values' shape."""
    if values.device.type == "cpu":
        return apply_lut256_plain(values, lut)
    if values.device.type != "cuda":
        raise RuntimeError(f"apply_lut256: unsupported device {values.device}")
    if lut.shape != (256,) or lut.device != values.device:
        raise ValueError("apply_lut256: lut must be (256,) on the values' device")
    x = _as_u8(values)
    table = lut.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().slam_lut256(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), x.numel(), _stream(x))
    _check(rc, "apply_lut256")
    LAUNCHES["apply_lut256"] += 1
    return out.reshape(values.shape)
