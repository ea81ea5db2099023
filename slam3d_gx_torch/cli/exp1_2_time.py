"""Stage-timing sweep over the detector zoo, on the card (counterpart of
the root exp1_2_time.py).

    python -m slam3d_gx_torch.cli.exp1_2_time [--pairs N] [--detectors A,B,...]
        [--descriptor S] [--seed S]

The reference's exp1_2_time.py:14-37: the planar experiment for each
detector, so data/time.log gathers `stage seconds` rows per detector
under a `# detector <name>` line.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

from ..config import ParameterReader
from . import exp1_2
from .exp1_2_sweep import count_frames

DEFAULT_DETECTORS = "GFTT,FAST,HARRIS,SIFT"


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--detectors", default=DEFAULT_DETECTORS)
    p.add_argument("--descriptor", default="SIFT")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    params = ParameterReader("./parameters.yaml")
    n_frames = count_frames(params.GetPara("data_source"))
    rng = random.Random(args.seed)
    os.makedirs("./data", exist_ok=True)
    for det in args.detectors.split(","):
        with open("./data/time.log", "a") as f:
            f.write(f"# detector {det}\n")
        for _ in range(args.pairs):
            a = rng.randrange(1, n_frames)
            b = min(a + rng.randrange(1, 5), n_frames)
            rc = exp1_2.main([str(a), str(b), det, args.descriptor, "p"], device=device)
            if rc != 0:
                print(f"{det} pair {a},{b} failed rc={rc}", file=sys.stderr)
        print(f"{det}: {args.pairs} pairs timed", flush=True)
    print("timing rows -> data/time.log")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
