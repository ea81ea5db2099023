"""convert2PCD: depth + rgb frames -> pcd/N.pcd (counterpart of
slam3d_gx_tpu/cli/convert2pcd.py).

    python -m slam3d_gx_torch.cli.convert2pcd start_index end_index

Parity target: reference src/convert2PCD.cpp:31-84:
- hardcoded intrinsics 525/525/319.5/235.5 and depth factor 1000
  (src/convert2PCD.cpp:19-23; the SLAM core reads the yaml's instead);
- reads ./rgb_index/N.png (color) and ./dep_index/N.png (16-bit) and
  writes ./pcd/N.pcd for N in [start, end);
- skips zero-depth pixels; packs rgba = r<<16 | g<<8 | b (line 65);
- savePCDFile's default, ASCII data.
The backprojection runs on the card (`device`, default the card); the
host decodes, drops the invalid pixels and writes the file.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..io import images, pcd
from ..ops import pointcloud


def convert_one(rgb_path: str, dep_path: str, out_path: str, fx: float = 525.0,
                fy: float = 525.0, cx: float = 319.5, cy: float = 235.5,
                factor: float = 1000.0, binary: bool = False, device=None) -> int:
    dev = resolve_device(device)
    rgb = images.load_color(rgb_path)
    dep = images.load_depth(dep_path)
    xyz, valid = pointcloud.backproject(torch.from_numpy(dep.astype(np.int32)).to(dev),
                                        fx, fy, cx, cy, factor)
    xyz_h, rgb_h = pointcloud.compact(xyz.reshape(-1, 3), valid.reshape(-1),
                                      rgb.reshape(-1, 3))
    rgba = pcd.pack_rgba(rgb_h[:, 0], rgb_h[:, 1], rgb_h[:, 2])
    pcd.write_pcd(out_path, xyz_h, rgba, binary=binary)
    return xyz_h.shape[0]


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("Usage: convert2pcd start_index end_index")
        return -1
    start, end = int(argv[0]), int(argv[1])
    os.makedirs("./pcd", exist_ok=True)
    for i in range(start, end):
        n = convert_one(f"./rgb_index/{i}.png", f"./dep_index/{i}.png", f"./pcd/{i}.pcd",
                        device=device)
        print(f"{i} of {end - start} files ok. ({n} points)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
