"""Hand-written CUDA kernels for Hopper, each beside its plain version.

| kernel | replaces (slam3d_gx_tpu/ops/pallas_kernels.py) | source |
|---|---|---|
| K1 `histogram256` | `_hist_kernel` / `_histogram256_pallas` | csrc/equalize.cu |
| K2 `apply_lut256` | `_lut_kernel` / `_apply_lut256_pallas` | csrc/equalize.cu |

K3 (`_min_eig_kernel`, the GFTT response) is not on this package's
path yet.
"""

from . import build, equalize  # noqa: F401
from .equalize import apply_lut256, histogram256  # noqa: F401

SOURCES = (equalize.SOURCE,)


def launch_counts() -> dict:
    """Launches of every kernel since the last `reset_counts`."""
    return dict(equalize.LAUNCHES)


def reset_counts() -> None:
    equalize.reset_counts()
