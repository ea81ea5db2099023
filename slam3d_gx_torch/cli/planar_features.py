"""planarFeatures [rgb.png] [depth.png]: classify FAST keypoints as planar
by a small plane RANSAC each, on the card (counterpart of
slam3d_gx_tpu/cli/planar_features.py).

    python -m slam3d_gx_torch.cli.planar_features rgb_index/1.png dep_index/1.png

The reference's src/planarFeatures.cpp:26-136: FAST keypoints (threshold
20) on the gray image, zero-depth ones dropped, the 7x7 depth patch
around each backprojected and fitted with a plane RANSAC (0.01 m); a
keypoint is planar when more than 40 of its 49 points are inliers
(isPlanar, lines 88-136). Prints the counts and writes
planar_features.png (planar keypoints green, the others red). All
keypoints' patches are fitted in one batched call.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import CameraIntrinsics, ParameterReader
from ..device import resolve_device
from ..io import images
from ..ops import plane_ransac
from ..ops.features import fast


def classify_planar(gray: torch.Tensor, depth: torch.Tensor, intr: CameraIntrinsics, sampler,
                    max_kp: int = 256, patch: int = 7, dist_thresh: float = 0.01,
                    min_inliers: int = 40, hypotheses: int = 64):
    """gray (H,W) uint8, depth (H,W) raw depth units; sampler: a plane
    sampler over the (K, patch^2) patch clouds. Returns (Keypoints,
    planar (K,) bool)."""
    kps = fast.detect_fast(gray, threshold=20.0, max_kp=max_kp)
    H, W = depth.shape
    r = patch // 2
    u0 = torch.clamp(torch.round(kps.uv[:, 0]).to(torch.int64), r, W - 1 - r)
    v0 = torch.clamp(torch.round(kps.uv[:, 1]).to(torch.int64), r, H - 1 - r)
    off = torch.arange(-r, r + 1, device=gray.device)
    # (K, patch^2) pixel coordinates, patch rows first
    uu = (u0[:, None, None] + off[None, None, :]).expand(-1, patch, patch).reshape(-1, patch**2)
    vv = (v0[:, None, None] + off[None, :, None]).expand(-1, patch, patch).reshape(-1, patch**2)
    d = depth[vv, uu].to(torch.float32)
    z = d / intr.factor
    x = (uu.to(torch.float32) - intr.cx) * z / intr.fx
    y = (vv.to(torch.float32) - intr.cy) * z / intr.fy
    kps = kps._replace(valid=kps.valid & (depth[v0, u0] > 0))
    _, _, counts = plane_ransac.fit_plane(torch.stack([x, y, z], -1), d > 0, sampler,
                                          dist_thresh=dist_thresh, hypotheses=hypotheses)
    return kps, kps.valid & (counts > min_inliers)


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rgb_path = argv[0] if len(argv) > 0 else "./rgb_1.png"
    dep_path = argv[1] if len(argv) > 1 else "./dep_1.png"
    dev = resolve_device(device)
    params = ParameterReader("./parameters.yaml" if os.path.exists("./parameters.yaml") else None)
    gray = images.load_gray(rgb_path)
    depth = images.load_depth(dep_path)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kps, planar = classify_planar(torch.from_numpy(gray).to(dev),
                                  torch.from_numpy(depth.astype(np.int32)).to(dev),
                                  params.intrinsics, plane_ransac.UniformSampler(gen))

    uv = kps.uv.cpu().numpy()
    val = kps.valid.cpu().numpy()
    pl = planar.cpu().numpy()
    print(f"keypoints: {val.sum()}, planar: {pl.sum()}")
    vis = np.stack([gray] * 3, -1)
    for i in np.nonzero(val)[0]:
        u, v = int(uv[i, 0]), int(uv[i, 1])
        vis[max(v - 2, 0):v + 3, max(u - 2, 0):u + 3] = (0, 255, 0) if pl[i] else (255, 0, 0)
    images.save_color("planar_features.png", vis)
    print("visualization saved to planar_features.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
