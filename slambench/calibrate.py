#!/usr/bin/env python3
"""Read the numbers `correct` compares, for the limits in checks/.

    python3 slambench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--plant tf32|bf16ref|unchanged|half_batch|half_reject|altered] [--seconds 20]

Runs the cell once per seed in this one process, as run.py does but
with `--trace 0` and, with --plant, the control or a planted fault
(harness/plants.py) in the program's place, and prints one JSON line a
seed: the seed, the plant, correct, each number compared and, without
--plant, the readings of the control `bf16ref` and of the fault
`unchanged` on the same run's outputs. The lower reading of a limit is
the largest a dozen seeds of the program give; the upper, the smallest
the control (or, for a number it does not reach, a fault) gives on three
seeds or more. Runs on the card.
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
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--plant", default=None)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from slambench.harness import bench, plants

    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        plant = plants.Plant(args.plant) if args.plant else None
        out = bench.run_cell(ROOT, args.workload, seed, args.seconds, False, t, plant=plant,
                             readings=plant is None)
        print(json.dumps({"seed": seed, "plant": args.plant, "correct": out["correct"],
                          "frames": out["attempted"], "lost": out["failed"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "checks": {k: v["value"] for k, v in out["checks"].items()},
                          "readings": out.get("readings")}),
              flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
