"""generateTrajectory keyframe.txt final.g2o: TUM trajectory export
(counterpart of slam3d_gx_tpu/cli/generate_trajectory.py; host only).

    python -m slam3d_gx_torch.cli.generate_trajectory data/keyframe.txt data/final_after.g2o

Parity target: reference src/generateTrajectory.cpp:17-81. Its getline/>>
walk (skip `frame - jump` getlines, then `>> timestamp`, jump = frame,
lines 53-76) nets out to: each keyframe row (id, frame) takes the first
token of line `frame` of associate.txt as the timestamp. Output rows:
`timestamp x y z qx qy qz qw ` in ./trajectory.txt.
"""

from __future__ import annotations

import os
import sys

from ..config import ParameterReader
from ..geometry import se3
from ..io import g2o_io, tum


def generate(keyframe_path: str, g2o_path: str, params: ParameterReader | None = None,
             out_path: str = "trajectory.txt") -> int:
    params = params or ParameterReader("./parameters.yaml")
    asso_path = os.path.join(params.GetPara("data_source"), "associate.txt")
    graph = g2o_io.load_g2o(g2o_path)
    with open(asso_path, "r") as asso:
        lines = asso.readlines()

    rows = []
    for kid, frame in tum.read_keyframes(keyframe_path):
        tok = lines[frame - 1].split() if 0 < frame <= len(lines) else []
        timestamp = tok[0] if tok else ""
        if kid not in graph.vertices:
            continue
        rows.append((timestamp, se3.get_estimate_data(graph.vertices[kid].T)))
    tum.write_trajectory(out_path, rows)
    print("trajectory saved.")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("generateTrajectory keyframe.txt final.g2o")
        return -1
    return generate(argv[0], argv[1])


if __name__ == "__main__":
    raise SystemExit(main())
