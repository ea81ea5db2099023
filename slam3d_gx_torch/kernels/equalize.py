"""The equalizeHist kernels: `equalize_hist256`, K1 `histogram256`, K2 `apply_lut256`.

`equalize_hist256` is the whole of `ops.imageproc.equalize_hist` in one
launch (histogram, CDF, LUT and lookup in one thread-block cluster) and
is what the main path runs once per frame. It replaces both Pallas TPU
kernels of slam3d_gx_tpu/ops/pallas_kernels.py (`_hist_kernel` behind
`histogram256`, `_lut_kernel` behind `apply_lut256`) and the 256-element
arithmetic between them. K1 and K2 remain as the port's counterparts of
the reference's two public functions. Sources, bounds and design notes:
csrc/equalize.cu.

Each wrapper takes the plain PyTorch version for a tensor on the CPU
and launches its kernel for a tensor on a CUDA device, or raises; it
never falls back. `LAUNCHES` counts kernel launches by name, and
nothing else adds to it.

Tolerance: 0. Counts and LUT entries are integers, and the LUT's two
float32 operations (255 / (total - first count), then one product) are
single correctly rounded IEEE operations in the kernel as in the plain
version, followed by round-half-to-even.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "equalize"
LAUNCHES = {"equalize_hist256": 0, "histogram256": 0, "apply_lut256": 0}
CLUSTER_BLOCKS = 8  # blocks of the one cluster that equalize_hist256 launches

_VP, _LL, _CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "slam_equalize256": [_VP, _VP, _LL, _CI, _VP],
    "slam_empty": [_CI, _VP],
    "slam_hist256": [_VP, _LL, _VP, _VP],
    "slam_lut256": [_VP, _VP, _VP, _LL, _VP],
}
_entries = {}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str):
    """The C function `name` of the built library, resolved and typed once."""
    if not _entries:
        _entries.update(build.bind(SOURCE, _ARGTYPES))
    return _entries[name]


def _launch(entry: str, device: torch.device, *args) -> None:
    """Call a C entry on `device`'s current stream; raise if the launch
    is refused."""
    build.launch(_entry(entry), entry, device, *args)


def _as_u8(values: torch.Tensor) -> torch.Tensor:
    """Flat contiguous uint8 view of integer-valued data in [0, 255]
    (the reference hands its kernels f32 holding such integers; the cast
    is exact for them)."""
    flat = values.reshape(-1)
    if flat.dtype != torch.uint8:
        flat = flat.to(torch.uint8)
    return flat.contiguous()


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
    _launch("slam_hist256", x.device, x.data_ptr(), x.numel(), out.data_ptr())
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
    _launch("slam_lut256", x.device, x.data_ptr(), table.data_ptr(), out.data_ptr(),
            x.numel())
    LAUNCHES["apply_lut256"] += 1
    return out.reshape(values.shape)


# -- the fused kernel ---------------------------------------------------------

def equalize_lut(hist: torch.Tensor, total: int) -> torch.Tensor:
    """cv::equalizeHist's LUT from a 256-bin histogram -> (256,) float32.

    The first non-empty bin maps to 0 and the rest follow the cumulative
    histogram scaled by 255/(total - hist[first]). A constant image gets
    the identity LUT, so applying it returns the image unchanged.
    """
    hist = hist.to(torch.int32)
    i0 = torch.argmax((hist > 0).to(torch.int32))
    h0 = hist[i0]
    scale = 255.0 / torch.clamp(total - h0, min=1)
    csum = torch.cumsum(hist, dim=0)
    rel = (csum - csum[i0]).to(torch.float32)
    lut = torch.clamp(torch.round(rel * scale), 0, 255)
    idx = torch.arange(256, device=hist.device)
    lut = torch.where(idx <= i0, 0.0, lut)
    return torch.where(h0 == total, idx.to(torch.float32), lut)


def equalize_hist256_plain(image: torch.Tensor) -> torch.Tensor:
    """cv::equalizeHist on integer-valued data in [0, 255] -> uint8."""
    lut = equalize_lut(histogram256_plain(image), image.numel())
    return apply_lut256_plain(image, lut)


def _launch_equalize256(x: torch.Tensor, cluster_blocks: int) -> torch.Tensor:
    """One launch over contiguous uint8 `x` on the card -> uint8, x's shape."""
    out = torch.empty_like(x)
    _launch("slam_equalize256", x.device, x.data_ptr(), out.data_ptr(), x.numel(),
            cluster_blocks)
    LAUNCHES["equalize_hist256"] += 1
    return out


def equalize_hist256(image: torch.Tensor) -> torch.Tensor:
    """cv::equalizeHist on integer-valued `image` in [0, 255], any shape
    -> uint8 of the same shape on the input's device: one kernel launch
    and no other device operation for a contiguous uint8 image."""
    if image.device.type == "cpu":
        return equalize_hist256_plain(image)
    if image.device.type != "cuda":
        raise RuntimeError(f"equalize_hist256: unsupported device {image.device}")
    if image.numel() >= 2 ** 31:
        raise ValueError("equalize_hist256: the kernel counts in int32, fewer than "
                         "2**31 pixels")
    x = image if image.dtype == torch.uint8 else image.to(torch.uint8)
    return _launch_equalize256(x.contiguous(), CLUSTER_BLOCKS)


def launch_empty(device: torch.device, cluster_blocks: int = CLUSTER_BLOCKS) -> None:
    """Launch a kernel that does nothing, in `equalize_hist256`'s grid,
    block and cluster shape: the fixed cost of such a launch, for
    measurement. Counted nowhere."""
    _launch("slam_empty", torch.device(device), cluster_blocks)
