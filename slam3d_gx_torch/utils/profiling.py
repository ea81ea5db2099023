"""Stage timing and device traces (counterpart of
slam3d_gx_tpu/utils/profiling.py).

The reference instruments its pipeline with gettimeofday pairs writing
`stage seconds` rows to data/time.log (reference
src/exp1/exp1_2.cpp:397-428,466-470). Here:

- StageTimer: host wall-clock timers writing the same time.log rows;
  `stop(t)` first waits for the CUDA device of tensor `t`, since its
  work is queued and the host's clock would stop before it ends;
- trace(): torch.profiler around a block (host and CUDA activity),
  written as a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StageTimer:
    """Accumulates `stage seconds` rows; write() appends them to time.log."""

    def __init__(self, path: str = "./data/time.log"):
        self.path = path
        self.rows = []
        self._t0 = None
        self._stage = None

    def start(self, stage: str):
        self._stage = stage
        self._t0 = time.time()

    def stop(self, sync: Optional[torch.Tensor] = None):
        """Ends the stage; with a tensor on a CUDA device, after that
        device has finished its queued work."""
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        self.rows.append((self._stage, time.time() - self._t0))
        self._stage = None

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Times the block; `sync` is a tensor or a callable returning one."""
        self.start(name)
        try:
            yield
        finally:
            self.stop(sync() if callable(sync) else sync)

    def write(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            for stage, secs in self.rows:
                f.write(f"{stage} {secs:g}\n")
        self.rows = []


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block, CUDA activity included when a card
    is present, written to `log_dir`/trace.json. log_dir defaults to
    $SLAM3D_TRACE_DIR, else ./data/trace. Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.environ.get("SLAM3D_TRACE_DIR", os.path.join("data", "trace"))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
