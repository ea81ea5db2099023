"""testRandom: the loop-closure sampler's random stream (counterpart of
slam3d_gx_tpu/cli/test_random.py; host only).

    python -m slam3d_gx_torch.cli.test_random [seed]

Parity target: reference src/testRandom.cpp:7-15 (100 draws of
rand()%100). The stream is seeded (default 0) instead of srand(time(0)),
and it is the `random.Random` stream the frontends' uniform loop-closure
sampler draws from, so runs are reproducible.
"""

from __future__ import annotations

import random
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    seed = int(argv[0]) if argv else 0
    rng = random.Random(seed)
    for _ in range(100):
        print(rng.randrange(100), end=" ")
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
