"""Runtime numeric and index checks (counterpart of
slam3d_gx_tpu/utils/debug.py).

The reference has no sanitizers (single-threaded C++, no -fsanitize);
the JAX package wraps a function with checkify's float and index checks.
Here a PyTorch dispatch mode watches every ATen operation the function
runs:

- float checks: every floating output of every operation is tested for
  NaN and Inf, and one counts when the operation made it from finite
  inputs (a constant such as the inf of `torch.where(mask, d, inf)` is
  not a fault, and a NaN is reported where it first appears);
- index checks: before an indexing operation runs (advanced indexing,
  index_select, gather, scatter, index_add/copy/fill/put, take,
  embedding), its index tensors are held to the bounds of the dimension
  they index. A CUDA index out of range is a device-side assert that
  ends the process, so such an operation is not run: the call stops
  there.

The error names the first operation at fault. The checks read values
back to the host, so a checked call waits for the device at every
operation: a debugging tool, not a path of the system.

Usage:
    from slam3d_gx_torch.utils import debug
    err, out = debug.checked(extract)(*args)   # err.throw() on demand
    extract_strict = debug.strict(extract)      # raises at once
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# operations whose index tensor is argument 2 and indexes dimension
# argument 1 of argument 0, in [0, size)
_DIM_INDEX_OPS = {aten.index_select, aten.gather, aten.scatter, aten.scatter_,
                  aten.scatter_add, aten.scatter_add_, aten.scatter_reduce,
                  aten.scatter_reduce_, aten.index_add, aten.index_add_,
                  aten.index_copy, aten.index_copy_, aten.index_fill, aten.index_fill_}
# operations whose argument 1 is a list of index tensors (None for a
# full slice) over the leading dimensions of argument 0, in [-size, size)
_LIST_INDEX_OPS = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}


class CheckError(RuntimeError):
    """A NaN/Inf or an index out of bounds found by a checked call."""


class Error:
    """What a checked call found: the first operation at fault, or nothing
    (the counterpart of checkify's Error)."""

    def __init__(self):
        self.msg: Optional[str] = None

    def get(self) -> Optional[str]:
        return self.msg

    def throw(self) -> None:
        if self.msg is not None:
            raise CheckError(self.msg)


class _Stop(Exception):
    """Ends a checked call at an operation that must not run."""


def _is_index(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.numel() > 0
            and not t.dtype.is_floating_point and t.dtype not in (torch.bool, torch.uint8))


def _bounds(index: torch.Tensor, size: int, negatives: bool) -> Optional[str]:
    lo, hi = int(index.min()), int(index.max())
    low = -size if negatives else 0
    if lo < low or hi >= size:
        return f"index {lo if lo < low else hi} outside [{low}, {size})"
    return None


def _finite(v) -> bool:
    if isinstance(v, torch.Tensor):
        return not v.dtype.is_floating_point or bool(torch.isfinite(v).all())
    return not isinstance(v, float) or math.isfinite(v)


def _float_fault(func, out, inputs) -> Optional[str]:
    """The NaN/Inf in `out` that `func` made from finite `inputs`."""
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.numel() and not _finite(t):
            if not any(isinstance(v, torch.Tensor) for v in inputs) \
                    or not all(_finite(v) for v in inputs):
                return None
            return f"{'nan' if bool(torch.isnan(t).any()) else 'inf'} generated by {func}"
    return None


def _index_fault(func, args) -> Optional[str]:
    packet = func.overloadpacket
    if packet in _DIM_INDEX_OPS and len(args) > 2 and _is_index(args[2]):
        x, dim = args[0], args[1]
        size = x.shape[dim] if x.dim() else 1
        return _bounds(args[2], size, negatives=False)
    if packet in _LIST_INDEX_OPS:
        x = args[0]
        for k, ix in enumerate(args[1]):
            if _is_index(ix):
                bad = _bounds(ix, x.shape[k], negatives=True)
                if bad:
                    return f"{bad} of dimension {k}"
        return None
    if packet is aten.take and _is_index(args[1]):
        return _bounds(args[1], args[0].numel(), negatives=True)
    if packet is aten.embedding and _is_index(args[1]):
        return _bounds(args[1], args[0].shape[0], negatives=False)
    return None


class _CheckMode(TorchDispatchMode):
    def __init__(self, error: Error):
        super().__init__()
        self.error = error

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        bad = _index_fault(func, args)
        if bad is not None:
            if self.error.msg is None:
                self.error.msg = f"out-of-bounds indexing in {func}: {bad}"
            raise _Stop
        out = func(*args, **kwargs)
        if self.error.msg is None:
            self.error.msg = _float_fault(func, out, tree_leaves((args, kwargs)))
        return out


def checked(fn: Callable) -> Callable:
    """fn' with fn'(*a, **k) -> (error, out): fn run with every operation
    checked. out is None when an index out of bounds stopped the call."""

    def run(*args, **kwargs):
        err = Error()
        try:
            with _CheckMode(err):
                out = fn(*args, **kwargs)
        except _Stop:
            out = None
        return err, out

    return run


def strict(fn: Callable) -> Callable:
    """fn' that raises CheckError at the first fault (debug runs)."""
    inner = checked(fn)

    def run(*args, **kwargs):
        err, out = inner(*args, **kwargs)
        err.throw()
        return out

    return run
