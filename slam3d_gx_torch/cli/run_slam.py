"""run_SLAM [loops]: the plane-based SLAM entry point on the card.

The reference's src/run_SLAM.cpp:11-44: construct frontend and backend,
cross-init, run `loops` frames (default 3), print the keyframe count,
save ./data/final.g2o (before optimization), then saveFinalResult
(findMoreLoops -> optimize -> keyframe.txt + final_after.g2o). Reads
./parameters.yaml. Runs on the CUDA device; `run(..., device="cpu")`
runs the plain PyTorch versions on the CPU.

On N cards, one process a card, with `mesh_devices: N` in
parameters.yaml:

    torchrun --nproc-per-node N -m slam3d_gx_torch.cli.run_slam 29

Each rank joins the process group from torchrun's environment and runs
the frontend; rank 0 prints and writes the files.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..backend import SLAMEnd
from ..config import ParameterReader
from ..frontend import GraphicEnd
from ..parallel import mesh as mesh_mod


def run(graphic_end_cls=GraphicEnd, argv=None, device=None, stats=None) -> int:
    """stats: optional dict that receives the frontend ("graphic_end")
    and the wall seconds of each frame's run(), synchronized with the
    device ("frame_seconds")."""
    argv = list(sys.argv[1:] if argv is None else argv)
    loops = int(argv[0]) if argv else 3

    mesh_mod.init_from_env(device)
    params = ParameterReader("./parameters.yaml")
    ge = graphic_end_cls(params, device=device)
    slam = SLAMEnd(device=device)
    ge.init(slam)
    slam.init(ge)

    say = print if ge.writes else (lambda *a: None)
    frame_seconds = []
    for i in range(loops):
        say("***************************")
        say(f"loop {i}")
        t0 = time.perf_counter()
        ge.run()
        if ge.device.type == "cuda":
            torch.cuda.synchronize(ge.device)
        frame_seconds.append(time.perf_counter() - t0)

    say(f"keyframes: {len(ge.keyframes)}")
    if ge.writes:
        os.makedirs("./data", exist_ok=True)
        slam.globalOptimizer.save("./data/final.g2o")
    ge.save_final_result("./data/result.pcd")
    if stats is not None:
        stats.update(graphic_end=ge, frame_seconds=frame_seconds)
    return 0


def main(argv=None) -> int:
    return run(GraphicEnd, argv)


if __name__ == "__main__":
    raise SystemExit(main())
