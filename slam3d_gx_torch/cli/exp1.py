"""exp1 frame1 frame2 detector descriptor p|n: pairwise registration with
headless visual output, on the card (counterpart of
slam3d_gx_tpu/cli/exp1.py).

    python -m slam3d_gx_torch.cli.exp1 1 3 GFTT SIFT p

The reference's src/exp1/exp1.cpp, the interactive sibling of exp1_2:
its drawMatches after the pooled RANSAC (exp1.cpp:388), its per-plane
images (exp1.cpp:578-582) and its per-plane match and inlier windows
(exp1.cpp:674-682) become PNGs under data/exp1/:

  match_<f1>_<f2>.png              all good matches (`n` mode)
  inliers_<f1>_<f2>.png            RANSAC inlier matches (`n` mode)
  plane_<f>_<p>.png                equalized masked plane image (`p` mode)
  plane_match_<f1>_<f2>_<p>.png    per-plane-pair good matches
  plane_inliers_<f1>_<f2>_<p>.png  per-plane-pair PnP inliers

The registration and the error.log row are exp1_2's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import ParameterReader
from ..device import resolve_device
from ..geometry import se3
from ..io import images
from ..ops import match as match_ops, plane_ransac, pnp
from ..utils import viz
from . import exp1_2


def _pairs_from(midx, sel) -> np.ndarray:
    """(K,) NN targets and a (K,) bool selection -> (M,2) index pairs."""
    src = np.nonzero(np.asarray(sel))[0]
    return (np.stack([src, np.asarray(midx)[src]], axis=1) if len(src)
            else np.zeros((0, 2), int))


def _plane_images_np(depth, gray, coeffs, valids, intr, dist_thresh, z_max):
    """Host-side recompute of the per-plane coverage images for dumping
    (the extractor does not return them): imageproc's membership images,
    off the device."""
    h, w = depth.shape
    vv, uu = np.mgrid[0:h, 0:w]
    z = depth.astype(np.float32) / intr.factor
    x = (uu - intr.cx) * z / intr.fx
    y = (vv - intr.cy) * z / intr.fy
    valid = (z > 0) & (z <= z_max)
    claimed = np.zeros((h, w), bool)
    out = []
    for p in range(coeffs.shape[0]):
        if not valids[p]:
            out.append(None)
            continue
        a, b, c, d = coeffs[p]
        dist = np.abs(a * x + b * y + c * z + d)
        m = (dist < dist_thresh) & valid & ~claimed
        claimed |= m
        out.append(np.where(m, gray, 0).astype(np.uint8))
    return out


def run_normal(out_dir, f1_idx, f2_idx, gray1, gray2, g1, d1, g2, intr, detector, descriptor,
               max_kp, u):
    """`n` mode: exp1_2's Matching, then the match and inlier PNGs."""
    k1, k2, midx, good, res = exp1_2.register_normal(g1, d1, g2, intr, detector, descriptor,
                                                      max_kp, u)
    uv1, uv2, midx = k1.uv.cpu().numpy(), k2.uv.cpu().numpy(), midx.cpu().numpy()
    for name, sel in (("match", good), ("inliers", res.inliers)):
        images.save_gray(os.path.join(out_dir, f"{name}_{f1_idx}_{f2_idx}.png"),
                         viz.draw_matches(gray1, uv1, gray2, uv2,
                                          _pairs_from(midx, sel.cpu().numpy())))
    return exp1_2.pose_inverse(res.rvec, res.tvec), int(res.n_inliers)


def run_planar(out_dir, f1_idx, f2_idx, frames, intr, params, detector, descriptor, max_kp,
               hypotheses, gen):
    """`p` mode: both extractions, the plane images, each plane pair's
    matches and RANSAC inliers, then the multiPnP. frames: two tuples
    (gray, depth as numpy; gray, depth, cloud, cloud mask as tensors)."""
    extract, multipnp = exp1_2.build_planar(intr, params, detector, descriptor, max_kp,
                                            hypotheses)
    sampler = plane_ransac.UniformSampler(gen)
    fa, fb = (extract(*f[2:], sampler) for f in frames)

    dist_thresh = params.get_float("distance_threshold")
    for tag, f, feats in ((f1_idx, frames[0], fa), (f2_idx, frames[1], fb)):
        planes = _plane_images_np(f[1], f[0], feats.coeffs.cpu().numpy(),
                                  feats.plane_valid.cpu().numpy(), intr, dist_thresh, z_max=7.0)
        for p, img in enumerate(planes):
            if img is not None:
                images.save_gray(os.path.join(out_dir, f"plane_{tag}_{p}.png"), img)

    pidx, _, pvalid = match_ops.match_planes(fa.coeffs, fa.plane_valid, fb.coeffs,
                                             fb.plane_valid)
    pidx, pvalid = pidx.cpu().numpy(), pvalid.cpu().numpy()
    gray1, gray2 = frames[0][0], frames[1][0]
    for p in range(fa.coeffs.shape[0]):
        if not pvalid[p]:
            continue
        q = int(pidx[p])
        midx, mdist, mok = match_ops.match_nn(fa.desc[p], fa.kp_valid[p], fb.desc[q],
                                              fb.kp_valid[q])
        good = match_ops.good_match_filter(mdist, mok)
        u = torch.rand((hypotheses, 3), generator=gen, device=gen.device)
        res_p = pnp.solve_pnp_ransac(fa.kp3d[p], fb.uv[q][midx], good, intr.fx, intr.fy,
                                     intr.cx, intr.cy, u, reproj_thresh=8.0)
        uva, uvb, midx = fa.uv[p].cpu().numpy(), fb.uv[q].cpu().numpy(), midx.cpu().numpy()
        for name, sel in (("plane_match", good), ("plane_inliers", res_p.inliers)):
            images.save_gray(os.path.join(out_dir, f"{name}_{f1_idx}_{f2_idx}_{p}.png"),
                             viz.draw_matches(gray1, uva, gray2, uvb,
                                              _pairs_from(midx, sel.cpu().numpy())))

    u = torch.rand((params.get_int("max_planes") + 2, hypotheses, 3), generator=gen,
                   device=gen.device)
    res = multipnp(fa, fb, u, 0)
    return se3.inverse(res.T.cpu().numpy().astype(np.float64)), int(res.inliers)


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 5:
        print("usage: exp1 frame1 frame2 detector descriptor p/n")
        return -1
    f1_idx, f2_idx, detector, descriptor, mode = argv
    if mode not in ("n", "p"):
        return -1
    dev = resolve_device(device)
    params = ParameterReader("./parameters.yaml")
    intr = params.intrinsics
    ds = params.GetPara("data_source")
    max_kp = params.get_int("max_keypoints")
    hypotheses = params.get_int("ransac_hypotheses")
    gen = torch.Generator(device=dev)
    gen.manual_seed(params.get_int("seed"))
    out_dir = "./data/exp1"
    os.makedirs(out_dir, exist_ok=True)

    gray1, dep1, g1, d1 = exp1_2.load_frame(ds, f1_idx, dev)
    gray2, dep2, g2, d2 = exp1_2.load_frame(ds, f2_idx, dev)
    Tr = exp1_2.ground_truth(ds, f1_idx, f2_idx)

    if mode == "n":
        u = torch.rand((hypotheses, 3), generator=gen, device=dev)
        T, n_inl = run_normal(out_dir, f1_idx, f2_idx, gray1, gray2, g1, d1, g2, intr,
                              detector, descriptor, max_kp, u)
    else:
        z_max, grid, cap, align = exp1_2.cloud_settings(params, gray1)
        frames = []
        for idx, gray, dep, g, d in ((f1_idx, gray1, dep1, g1, d1), (f2_idx, gray2, dep2, g2, d2)):
            cloud = exp1_2.load_cloud(os.path.join(ds, f"pcd/{idx}.pcd"), z_max, grid, cap, dev,
                                      dep, intr, align)
            frames.append((gray, dep, g, d, *cloud))
        T, n_inl = run_planar(out_dir, f1_idx, f2_idx, frames, intr, params, detector,
                              descriptor, max_kp, hypotheses, gen)
    exp1_2.append_error(os.path.join(out_dir, "error.log"), f1_idx, f2_idx, Tr, T, n_inl)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
