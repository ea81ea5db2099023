"""Bulk pairwise-registration sweep over the port's exp1_2, on the card
(counterpart of the root exp1_2.py).

    python -m slam3d_gx_torch.cli.exp1_2_sweep [--anchors N] [--offsets K]
        [--detector D] [--descriptor S] [--modes pn] [--subprocess] [--seed S]

The reference's exp1_2.py:14-27: random anchor frames x offsets 1..K,
each pair registered with the planar ('p') and normal ('n') pipelines,
the errors appended to data/exp1/error.log by exp1_2. Pairs run in this
process by default; `--subprocess` runs one
`python -m slam3d_gx_torch.cli.exp1_2` per pair, the reference's layout.
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys

from ..config import ParameterReader
from . import exp1_2


def count_frames(data_source: str) -> int:
    with open(os.path.join(data_source, "associate.txt")) as f:
        return sum(1 for line in f if line.strip())


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--anchors", type=int, default=100)
    p.add_argument("--offsets", type=int, default=19)
    p.add_argument("--detector", default="GFTT")
    p.add_argument("--descriptor", default="SIFT")
    p.add_argument("--modes", default="pn",
                   help="p=planar, n=normal, pn=both (the reference sweeps both)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--subprocess", action="store_true",
                   help="one process per pair (the reference's layout)")
    args = p.parse_args(argv)

    params = ParameterReader("./parameters.yaml")
    n_frames = count_frames(params.GetPara("data_source"))
    rng = random.Random(args.seed)
    pairs = []
    for _ in range(args.anchors):
        a = rng.randrange(1, max(2, n_frames - args.offsets))
        for off in range(1, args.offsets + 1):
            if a + off <= n_frames:
                pairs.append((a, a + off))

    for i, (a, b) in enumerate(pairs):
        for mode in args.modes:
            argv_pair = [str(a), str(b), args.detector, args.descriptor, mode]
            if args.subprocess:
                rc = subprocess.run([sys.executable, "-m", "slam3d_gx_torch.cli.exp1_2",
                                     *argv_pair], check=False).returncode
            else:
                rc = exp1_2.main(argv_pair, device=device)
            if rc != 0:
                print(f"pair {a},{b} mode {mode} failed rc={rc}", file=sys.stderr)
        if (i + 1) % 20 == 0:
            print(f"{i + 1}/{len(pairs)} pairs done", flush=True)
    print(f"swept {len(pairs)} pairs -> data/exp1/error.log")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
