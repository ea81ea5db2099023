"""run_SLAM_streaming [loops] [chunk] [planes|imageonly]: chunked SLAM on
the card.

The JAX package's extension of run_SLAM / run_SLAM_imageonly (reference
src/run_SLAM*.cpp), with the same outputs: the tracking state machine
runs `chunk` frames per dispatch with one readback of its records per
chunk (frontend/streaming.py). Defaults: 3 loops, chunks of 8, the
image-only pipeline. Reads ./parameters.yaml; runs on the CUDA device,
`main(..., device="cpu")` on the CPU.

    python -m slam3d_gx_torch.cli.run_slam_streaming 29 8 planes

On N cards with `mesh_devices: N`, as run_slam:
`torchrun --nproc-per-node N -m slam3d_gx_torch.cli.run_slam_streaming ...`.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..backend import SLAMEnd
from ..config import ParameterReader
from ..frontend.streaming import StreamingGraphicEnd, StreamingGraphicEnd2
from ..parallel import mesh as mesh_mod


def main(argv=None, device=None, stats=None) -> int:
    """stats: optional dict that receives the frontend ("graphic_end"),
    the frames processed ("frames"), the wall seconds of run_streaming
    synchronized with the device ("seconds") and, on the card, per chunk
    dispatch whether its carry came from the host and where it
    synchronized ("chunk_syncs", see `_StreamingMixin.sync_log`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    loops = int(argv[0]) if argv else 3
    chunk = int(argv[1]) if len(argv) > 1 else 8
    kind = argv[2] if len(argv) > 2 else "imageonly"
    if kind not in ("planes", "imageonly"):
        raise ValueError(f"pipeline: {kind!r} (planes or imageonly)")

    mesh_mod.init_from_env(device)
    params = ParameterReader("./parameters.yaml")
    cls = StreamingGraphicEnd if kind == "planes" else StreamingGraphicEnd2
    ge = cls(params, chunk=chunk, device=device)
    slam = SLAMEnd(device=device)
    ge.init(slam)
    slam.init(ge)
    if stats is not None:
        ge.sync_log = []

    t0 = time.perf_counter()
    done = ge.run_streaming(loops)
    if ge.device.type == "cuda":
        torch.cuda.synchronize(ge.device)
    seconds = time.perf_counter() - t0
    say = print if ge.writes else (lambda *a: None)
    say(f"processed {done} frames in chunks of {chunk}")

    say(f"keyframes: {len(ge.keyframes)}")
    ge.drain_pending_loop_closures()
    if ge.writes:
        os.makedirs("./data", exist_ok=True)
        slam.globalOptimizer.save("./data/final.g2o")
    ge.save_final_result("./data/result.pcd")
    if stats is not None:
        stats.update(graphic_end=ge, frames=done, seconds=seconds, chunk_syncs=ge.sync_log)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
