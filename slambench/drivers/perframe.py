"""Per-frame driver: one session as `cli/run_slam.py` (GraphicEnd) or
`cli/run_slam_imageonly.py` (GraphicEnd2) drives it.

construct the frontend and the backend, cross-init (init reads and
extracts the first frame), `run()` once per further frame with a device
synchronize after each (the CLI's per-frame wall), save data/final.g2o,
then `save_final_result` (findMoreLoops, optimize, keyframe.txt,
final_after.g2o).
"""

from __future__ import annotations

import os
import time


def run_session(ctx, workdir: str, frames: int) -> dict:
    """Returns {"frames": frames processed (init's included), "walls":
    run() seconds, "finalize_s": the wait from the last run()'s return to
    the end of save_final_result, "ge": the frontend}."""
    from slam3d_gx_torch.backend import SLAMEnd
    from slam3d_gx_torch.config import ParameterReader
    from slam3d_gx_torch.parallel import mesh as mesh_mod

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        mesh_mod.init_from_env(ctx.device)
        params = ParameterReader("./parameters.yaml")
        ge = ctx.frontend_cls(params, device=ctx.device)
        slam = SLAMEnd(device=ctx.device)
        ctx.instrument(ge, slam.globalOptimizer)
        ge.init(slam)
        slam.init(ge)
        ctx.sync()
        done, walls = 1, []
        for _ in range(frames - 1):
            t0 = time.perf_counter()
            ge.run()
            ctx.sync()
            walls.append(time.perf_counter() - t0)
            done += 1
        t0 = time.perf_counter()
        os.makedirs("./data", exist_ok=True)
        slam.globalOptimizer.save("./data/final.g2o")
        ge.save_final_result("./data/result.pcd")
        ctx.sync()
        finalize = time.perf_counter() - t0
        return {"frames": done, "walls": walls, "finalize_s": finalize, "ge": ge}
    finally:
        os.chdir(cwd)
