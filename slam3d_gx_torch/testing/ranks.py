"""Run a function on N ranks of a gloo process group on the CPU: the
multi-device layer's tests without a card.

    results = ranks.run(worker, 4, tmp_dir, arg1, ...)

starts 4 processes (torch.multiprocessing, spawn), joins them in a gloo
group through a file:// rendezvous in `tmp_dir`, calls
`worker(rank, world, *args)` in each and returns the values they
returned, in rank order. `worker` must be importable by its module name
(a module-level function) and its value picklable.
"""

from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, world: int, tmp_dir: str, threads: int, fn, args):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp_dir, 'rendezvous')}",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run(fn, world: int, tmp_dir: str, *args, threads: int = 2) -> list:
    """fn(rank, world, *args) on `world` gloo ranks; their results in rank
    order. Each rank runs `threads` intra-op threads."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    mp.spawn(_entry, args=(world, tmp_dir, threads, fn, args), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
