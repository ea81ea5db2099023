"""The table of peaks and the byte counts of the port's kernels.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W
limit (chip_smoke.py's PEAK_BYTES_PER_S and PEAK_SCALAR_OPS): HBM3 at
3.35 TB/s, float32 outside the tensor cores at 67 Tflop/s. A kernel's
bound counts each input byte read once and each output byte written
once (chip_smoke.py's bound() and min_eig_bound()).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12


def bound_s(nbytes: int, flops: int = 0) -> float:
    """The least time: the larger of bytes over bandwidth and operations
    over the float32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S)


def min_eig_bytes(height: int, width: int) -> int:
    """K3: the uint8 frame read once, the float32 response written once."""
    return height * width * (1 + 4)


def min_eig_flops(height: int, width: int) -> int:
    """K3's ~55 flop a pixel: two 6-tap Sobels, three products, three
    9-tap box sums and the closed-form eigenvalue."""
    return 55 * height * width


def equalize_bytes(height: int, width: int) -> int:
    """equalize_hist256: the uint8 frame read once and written once."""
    return 2 * height * width


def kernel_mean_s(run, name: str):
    """Mean device seconds of the traced kernels whose name contains
    `name`, or None when the trace holds none."""
    if not run.trace:
        return None
    times = [t for k, v in run.trace["kernels"].items() if name in k for t in v]
    return sum(times) / len(times) if times else None
