"""Process groups and the (dp, sp) device mesh
(counterpart of slam3d_gx_tpu/parallel/mesh.py).

One process a card, as PyTorch runs several GPUs: `torchrun` (or the
caller) starts N ranks, `distributed_init` joins them in a process group
(NCCL on CUDA, gloo on the CPU), and `make_mesh` lays them out as a
`DeviceMesh` with the JAX package's axis names:

- "dp": data parallel. Loop-closure candidates and pose-graph edges are
  split over it;
- "sp": sequence parallel. The keyframe database's rows are split over it.

Ranks are laid out row-major, as JAX's `devices.reshape((dp, sp))`: four
ranks [[0, 1], [2, 3]] give dp groups {0, 2}, {1, 3} and sp groups
{0, 1}, {2, 3}. Every rank runs the whole frontend with the same seeds
and reaches the same decisions; only the sharded components split work,
and their collectives put the whole result on every rank. A mesh of size
1 is a one-rank group and takes the same code.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

DP_AXIS = "dp"
SP_AXIS = "sp"

# all_gather_into_tensor is deprecated in newer PyTorch for this name
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def rank_device(device=None) -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` (raising without a card)
    unless the caller asks for another, for example "cpu"."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None) -> None:
    """Join this process to a group of `num_processes` ranks: at
    `tcp://coordinator` (host:port), or from the environment that
    `torchrun` sets (`env://`). A no-op at one process or fewer, and when
    a group already exists."""
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = int(os.environ.get("RANK", "0")) if process_id is None else process_id
    dist.init_process_group(
        _backend(dev), init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=num_processes, rank=rank)


def init_from_env(device=None) -> None:
    """`distributed_init` from torchrun's WORLD_SIZE and RANK, when
    WORLD_SIZE is above 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        distributed_init(None, world, int(os.environ.get("RANK", "0")), device=device)


def _init_one_rank(dev: torch.device) -> None:
    """A group of this process alone, on a free localhost port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev), init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)


def _factor_2d(n: int) -> Tuple[int, int]:
    """Factor n into (dp, sp) as square as possible, dp >= sp."""
    best = (n, 1)
    for sp in range(1, int(math.isqrt(n)) + 1):
        if n % sp == 0:
            best = (n // sp, sp)
    return best


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = (DP_AXIS, SP_AXIS),
              shape: Optional[Sequence[int]] = None, device=None):
    """The DeviceMesh over all ranks of the process group. dp takes the
    larger factor of a 2D layout (registration fan-out dominates).
    n_devices must equal the group's world size (None takes it); with no
    group, n_devices 1 starts a one-rank group itself and anything else
    raises. `device`: the rank's device, as `rank_device` takes it."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = rank_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs {n_devices} ranks in a process "
                f"group: start one process a device, e.g. torchrun --nproc-per-node "
                f"{n_devices}")
        _init_one_rank(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices, but the process group has {world} ranks: start "
            f"one process a device, e.g. torchrun --nproc-per-node {n}")
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            shape = _factor_2d(n)
        else:
            raise ValueError("provide shape for >2 axes")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axis_names))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _has_axis(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """Ranks along `axis`; 1 without a mesh or without that axis."""
    if not _has_axis(mesh, axis):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 without one)."""
    return 0 if axis_size(mesh, axis) == 1 else mesh.get_local_rank(axis)


def shard_rows(x: torch.Tensor, mesh, axis: str, n_pad: Optional[int] = None) -> torch.Tensor:
    """This rank's block of rows along `axis` of x padded to `n_pad`
    rows (a multiple of the axis size; default: x's rows). Padding rows
    repeat row 0; the caller discards their results."""
    k = axis_size(mesh, axis)
    n = x.shape[0]
    n_pad = n if n_pad is None else n_pad
    if n_pad % k:
        raise ValueError(f"{n_pad} rows do not split over {k} ranks of {axis!r}")
    if k == 1 and n_pad == n:
        return x
    per = n_pad // k
    r = axis_rank(mesh, axis)
    idx = torch.arange(r * per, (r + 1) * per, device=x.device)
    return x.index_select(0, torch.where(idx < n, idx, 0))


def gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's rows of x along `axis`, in rank order: (k * rows, ...)
    on every rank (x itself when the mesh has no such axis).
    Stream-ordered on CUDA: the host does not wait."""
    if not _has_axis(mesh, axis):
        return x
    x = x.contiguous()
    out = torch.empty((axis_size(mesh, axis) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, x, group=mesh.get_group(axis))
    return out


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x summed over the ranks along `axis`, in place (unchanged when the
    mesh has no such axis); returns x."""
    if _has_axis(mesh, axis):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def world_size() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_rank() -> bool:
    """Rank 0 of the process group, or no group: the process that prints
    and writes a run's files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (none: no-op)."""
    if dist.is_initialized():
        dist.barrier()
