"""viewLC: replay detected loop closures, headless (counterpart of
slam3d_gx_tpu/cli/view_lc.py; host only).

    python -m slam3d_gx_torch.cli.view_lc [data/lc.txt [out_dir]]

Parity target: reference src/viewLC.cpp:20-65. Reads lc.txt rows
(`frame1 frame2 norm inliers`, the 4-column format of
src/GraphicEnd.cpp:861; older 3-column files too) and, for each closure
whose frames are on disk, writes both rgb frames side by side as
out_dir/lc_<f1>_<f2>.png where the reference shows a window.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..config import ParameterReader
from ..io import images, tum


def view(lc_path: str, params: ParameterReader | None = None, out_dir: str = "./lc_view") -> int:
    params = params or ParameterReader("./parameters.yaml")
    rgb_path, _, _ = tum.dataset_paths(params.GetPara("data_source"))
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(lc_path, "r") as f:
        for raw in f:
            tok = raw.split()
            if len(tok) < 2:
                continue
            f1, f2 = int(tok[0]), int(tok[1])
            norm = tok[2] if len(tok) > 2 else "?"
            inl = tok[3] if len(tok) > 3 else "?"
            print(f"loop closure: {f1} <-> {f2} norm={norm} inliers={inl}")
            try:
                a = images.load_gray(os.path.join(rgb_path, f"{f1}.png"))
                b = images.load_gray(os.path.join(rgb_path, f"{f2}.png"))
            except FileNotFoundError:
                continue
            h = max(a.shape[0], b.shape[0])
            canvas = np.zeros((h, a.shape[1] + b.shape[1]), np.uint8)
            canvas[: a.shape[0], : a.shape[1]] = a
            canvas[: b.shape[0], a.shape[1]:] = b
            images.save_gray(os.path.join(out_dir, f"lc_{f1}_{f2}.png"), canvas)
            n += 1
    print(f"{n} loop closures rendered to {out_dir}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    lc = argv[0] if argv else "./data/lc.txt"
    if len(argv) > 1:
        return view(lc, out_dir=argv[1])
    return view(lc)


if __name__ == "__main__":
    raise SystemExit(main())
