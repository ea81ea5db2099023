"""K3 `min_eig_response`: the Shi-Tomasi corner response as one CUDA kernel.

It replaces the Pallas TPU kernel `_min_eig_kernel`
(slam3d_gx_tpu/ops/pallas_kernels.py, launched by
`min_eig_response_fused`), which the GFTT detector calls once per frame
extraction. Source, bound and design notes: csrc/min_eig.cu.

The wrapper takes the plain PyTorch version for a tensor on the CPU and
launches the kernel for a tensor on a CUDA device, or raises; it never
falls back. `LAUNCHES` counts kernel launches, and nothing else adds to
it.

Tolerance: the kernel does the plain version's operations in its order,
each rounded to nearest (no FMA; IEEE division and sqrt). The plain
version differs in last bits only: on the card PyTorch divides by a
scalar as a product with its reciprocal, and on the CPU its sqrt is not
always correctly rounded. The two are held to 1e-6 of the image's
largest box sum (the response is a difference of two such sums); on a
480x640 uint8 image that is 3e-6 of the largest response.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.features.common import box_filter, sobel_gradients
from . import build
from .equalize import _check, _stream

SOURCE = "min_eig"
LAUNCHES = {"min_eig_response": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.slam_min_eig.argtypes = [vp, ci, ci, ci, vp, vp]
        lib.slam_min_eig.restype = ctypes.c_int
        lib._typed = True
    return lib


def structure_tensor(img: torch.Tensor, block_radius: int = 1):
    """Box means of the Sobel gradient products: (sxx, syy, sxy)."""
    dx, dy = sobel_gradients(img)
    return (box_filter(dx * dx, block_radius), box_filter(dy * dy, block_radius),
            box_filter(dx * dy, block_radius))


def min_eig_response_plain(img: torch.Tensor, block_radius: int = 1) -> torch.Tensor:
    """Shi-Tomasi: the smaller eigenvalue of the 2x2 structure tensor.
    (H,W) uint8 or float -> (H,W) f32, in the reference's order of
    operations (harris.min_eig_response)."""
    sxx, syy, sxy = structure_tensor(img.to(torch.float32), block_radius)
    tr_half = (sxx + syy) * 0.5
    d = (sxx - syy) * 0.5
    return tr_half - torch.sqrt(d * d + sxy * sxy)


def min_eig_response(img: torch.Tensor) -> torch.Tensor:
    """Shi-Tomasi response map of an (H,W) image, H, W >= 1, uint8 or
    float -> (H,W) f32 on the input's device. The kernel reads uint8
    directly; other types are cast to f32 first."""
    if img.dim() != 2 or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"min_eig_response: expected a non-empty (H,W) image, got "
                         f"{tuple(img.shape)}")
    if img.device.type == "cpu":
        return min_eig_response_plain(img)
    if img.device.type != "cuda":
        raise RuntimeError(f"min_eig_response: unsupported device {img.device}")
    if img.dtype not in (torch.uint8, torch.float32):
        img = img.to(torch.float32)
    x = img.contiguous()
    H, W = x.shape
    out = torch.empty((H, W), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().slam_min_eig(
            ctypes.c_void_p(x.data_ptr()), int(x.dtype == torch.uint8), H, W,
            ctypes.c_void_p(out.data_ptr()), _stream(x))
    _check(rc, "min_eig_response")
    LAUNCHES["min_eig_response"] += 1
    return out
