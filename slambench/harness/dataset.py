"""Write rendered frames in the TUM RGB-D layout that the program reads.

rgb_index/N.png (8-bit gray), dep_index/N.png (16-bit depth, raw units
of `factor`) and associate.txt with the ground-truth pose of each frame,
N from 1: the layout of the reference's prepared fr1 sequences (its tools/prepare.sh)
and of the original generator's write_dataset.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

PNG_LEVEL = 1  # zlib level: every run writes its frames anew


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw) with qw >= 0."""
    w = 0.5 * np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2]))
    x = 0.5 * np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2]))
    y = 0.5 * np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2]))
    z = 0.5 * np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2]))
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    return np.array([x, y, z, w])


def write_tum(root: str, gray: torch.Tensor, depth: torch.Tensor, poses,
              threads: int = 4) -> None:
    """Write every frame under `root` (which must exist)."""
    dirs = [os.path.join(root, d) for d in ("rgb_index", "dep_index")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    g_host = gray.cpu().numpy()
    d_host = depth.cpu().numpy().astype(np.uint16)

    def one(i: int) -> None:
        n = i + 1
        Image.fromarray(g_host[i], mode="L").save(
            os.path.join(dirs[0], f"{n}.png"), compress_level=PNG_LEVEL)
        Image.fromarray(d_host[i]).save(os.path.join(dirs[1], f"{n}.png"),
                                        compress_level=PNG_LEVEL)

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(one, range(g_host.shape[0])))
    rows = []
    for n, T in enumerate(poses, start=1):
        ts = f"{1000.0 + 0.033 * n:.6f}"
        pose = " ".join(f"{x:.9g}" for x in np.concatenate([T[:3, 3], rot_to_quat(T[:3, :3])]))
        rows.append(f"{ts} rgb_index/{n}.png {ts} dep_index/{n}.png {ts} {pose}")
    with open(os.path.join(root, "associate.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
