"""Hand-written CUDA kernels for Hopper, each beside its plain version.

| kernel | replaces (slam3d_gx_tpu/ops/pallas_kernels.py) | source, design |
|---|---|---|
| `equalize_hist256` (the main path's) | `_hist_kernel` and `_lut_kernel` | csrc/equalize.cu, one cluster |
| K1 `histogram256` | `_hist_kernel` / `_histogram256_pallas` | csrc/equalize.cu, off the path |
| K2 `apply_lut256` | `_lut_kernel` / `_apply_lut256_pallas` | csrc/equalize.cu, off the path |
| K3 `min_eig_response` | `_min_eig_kernel` / `min_eig_response_fused` | csrc/min_eig.cu, one wave |
| `refine_lm` | none: the JAX `refine_pnp` loop, which XLA fuses | csrc/refine_lm.cu, a block a problem |

These are all the TPU kernels of the JAX package, and each has had its
Hopper redesign: K1 and K2 as `equalize_hist256`, K3 as one resident
wave of register-blocked warps (its first design stays in the same
source, off every path, as the yardstick). `refine_lm` is the PnP
solve's whole Levenberg-Marquardt polish in one launch, in place of the
thousands of small launches PyTorch runs it as.
"""

from . import build, equalize, min_eig, refine_lm  # noqa: F401
from .equalize import apply_lut256, equalize_hist256, histogram256  # noqa: F401
from .min_eig import min_eig_response  # noqa: F401

SOURCES = (equalize.SOURCE, min_eig.SOURCE, refine_lm.SOURCE)
_MODULES = (equalize, min_eig, refine_lm)


def launch_counts() -> dict:
    """Launches of every kernel since the last `reset_counts`."""
    return {k: v for m in _MODULES for k, v in m.LAUNCHES.items()}


def reset_counts() -> None:
    for m in _MODULES:
        m.reset_counts()
