"""saveOutput keyframe.txt final.g2o [pass_z]: global map fusion
(counterpart of slam3d_gx_tpu/cli/save_output.py).

    python -m slam3d_gx_torch.cli.save_output data/keyframe.txt data/final_after.g2o [5.0]

Parity target: reference src/saveOutput.cpp:18-98. Per keyframe row
(id, frame): load pcd/<frame>.pcd, voxel grid at `grid_leaf`, z
passthrough (0..pass_z, default 5.0), transform by the vertex estimate;
then one voxel grid over the fused map, written as ASCII ./result.pcd
(savePCDFile's default). The voxel grids, the passthrough and the
transform run on the card (`device`, default the card): the same
centroid and sorted-leaf semantics as the JAX package's host numpy
fusion, whose sums run in another order.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import ParameterReader
from ..device import resolve_device
from ..io import g2o_io, pcd as pcd_io, tum
from ..ops import pointcloud


def _voxel_grid(xyz: torch.Tensor, rgb: torch.Tensor, leaf: float):
    """Every occupied voxel's centroid of position and color, packed."""
    if xyz.shape[0] == 0:
        return xyz, rgb
    mask = torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    vx, vc, m = pointcloud.voxel_downsample(xyz, rgb, mask, leaf)
    n = int(m.sum())  # the voxels are packed to the front
    return vx[:n], vc[:n]


def fuse_map(keyframe_path: str, g2o_path: str, pass_z: float = 5.0,
             params: ParameterReader | None = None, out_path: str = "result.pcd",
             device=None) -> int:
    params = params or ParameterReader("./parameters.yaml")
    dev = resolve_device(device)
    grid_leaf = params.get_float("grid_leaf")
    _, _, pcl_path = tum.dataset_paths(params.GetPara("data_source"))
    graph = g2o_io.load_g2o(g2o_path)

    out_xyz, out_rgb = [], []
    for kid, frame in tum.read_keyframes(keyframe_path):
        if kid not in graph.vertices:
            print(f"cannot find vertex: {kid}")
            continue
        path = os.path.join(pcl_path, f"{frame}.pcd")
        print(f"loading {path}")
        xyz, rgba = pcd_io.read_pcd(path)
        rgb = np.stack(pcd_io.unpack_rgba(rgba), -1).astype(np.float32)
        vx, vc = _voxel_grid(torch.from_numpy(xyz).to(dev), torch.from_numpy(rgb).to(dev),
                             grid_leaf)
        keep = pointcloud.passthrough_z(vx, torch.ones_like(vx[:, 0], dtype=torch.bool),
                                        0.0, pass_z)
        pos = torch.as_tensor(graph.vertices[kid].T, dtype=torch.float32, device=dev)
        out_xyz.append(pointcloud.transform_points(pos, vx[keep]))
        out_rgb.append(vc[keep])

    if not out_xyz:
        print("no keyframes fused")
        return -1
    xyz, rgb = _voxel_grid(torch.cat(out_xyz), torch.cat(out_rgb), grid_leaf)
    rgb_u8 = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8).cpu().numpy()
    rgba = pcd_io.pack_rgba(rgb_u8[:, 0], rgb_u8[:, 1], rgb_u8[:, 2])
    pcd_io.write_pcd(out_path, xyz.cpu().numpy(), rgba, binary=False)
    print("final result saved.")
    return 0


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("saveOutput keyframe.txt final.g2o [ pass_z ]")
        return -1
    pass_z = float(argv[2]) if len(argv) >= 3 else 5.0
    return fuse_map(argv[0], argv[1], pass_z, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
