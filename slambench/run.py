#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Renders the cell's sequences on the card (the traffic's trajectory
through rooms whose textures, and a sensor noise, are drawn from
--seed), writes them in the TUM layout under $TMPDIR, warms the cell's
own path with one short session, then runs whole passes back to back. A
pass is one SLAM session (slam3d_gx_torch's GraphicEnd2, driven as its
run_SLAM_imageonly CLI drives it) over each sequence, with RANSAC draws
also drawn from --seed; every pass replays the first's sequences and
draws, and a new one starts only while --seconds have not passed (a
least length: passes are never cut). Then it checks what the window produced
against the plain reference and prints one JSON line: correct, attempted
(frames), failed (frames the tracker lost), metrics (--trace 0: the
cell's end-to-end metrics; --trace 1: its per-layer metrics, the first
session under torch.profiler), device and, last, checks (each number
compared and its limit, also the last lines of standard error). Exits
non-zero, printing no result, without enough CUDA cards.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from slambench.harness import bench

    chips = bench.Cell(ROOT, args.workload).spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = bench.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
