"""exp1_2 frame1 frame2 detector descriptor p|n: pairwise registration
with ground truth and stage timing, on the card
(counterpart of slam3d_gx_tpu/cli/exp1_2.py).

    python -m slam3d_gx_torch.cli.exp1_2 1 3 GFTT SIFT n

The reference's src/exp1/exp1_2.cpp:179-470, in a directory with
`parameters.yaml`:
- loads both frames (rgb/dep/pcd) with z-passthrough and voxel filters.
  The reference reads the z limit from `optimize_step` (exp1_2.cpp:211),
  a config-key slip that in effect turns z filtering off; kept;
- the ground truth from associate.txt as plain setEstimateData (conv2Odo,
  exp1_2.cpp:141-158, no odometry remap), Tr = T1^-1 T2;
- `n`: full-image matching (floor max(3*min_dist, 5.0),
  exp1_2.cpp:322-331), zero-depth keypoints dropped, RANSAC at 8 px,
  returns T^-1;
- `p`: MatchingPlanar, the plane pipeline with the pooled RANSAC at
  `ransac_accuracy`, returns T^-1; the stage rows `stage seconds` go to
  data/time.log (exp1_2.cpp:397-470), as synchronized wall times;
- the row `f1 f2 gt_trans gt_rot err_trans err_rot inliers` is appended
  to data/exp1/error.log (exp1_2.cpp:292-295).

The RANSAC draws come from a torch.Generator seeded by `seed`; the
registration functions take them as an argument.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..config import CameraIntrinsics, ParameterReader
from ..device import resolve_device
from ..frontend import pipeline
from ..geometry import se3
from ..io import images, pcd as pcd_io, tum
from ..ops import lie, match as match_ops, plane_ransac, pnp, pointcloud
from ..ops.features import registry


def error_angle(T: np.ndarray) -> float:
    return float(np.arccos(min(1.0, max(-1.0, (np.trace(T[:3, :3]) - 1.0) / 2.0))))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_frame(ds: str, idx: str, device: torch.device):
    """(gray, depth) as numpy and as tensors on `device`: uint8 gray,
    int32 depth."""
    gray = images.load_gray(os.path.join(ds, f"rgb_index/{idx}.png"))
    depth = images.load_depth(os.path.join(ds, f"dep_index/{idx}.png"))
    return (gray, depth, torch.from_numpy(gray).to(device),
            torch.from_numpy(depth.astype(np.int32)).to(device))


def ground_truth(ds: str, f1_idx: str, f2_idx: str) -> np.ndarray:
    """Tr = T1^-1 T2 from associate.txt, no odometry remap (conv2Odo,
    exp1_2.cpp:141-145)."""
    rows = tum.read_associate(os.path.join(ds, "associate.txt"))
    T1 = se3.set_estimate_data(rows[int(f1_idx) - 1].pose)
    T2 = se3.set_estimate_data(rows[int(f2_idx) - 1].pose)
    return se3.inverse(T1) @ T2


def load_cloud(path: str, z_max: float, grid_leaf: float, cap: int, device,
               depth=None, intr: CameraIntrinsics | None = None, align_scale: bool = True):
    """A PCD padded to one fixed capacity `cap` (larger clouds are
    stride-decimated to fit), z-passthrough then voxel grid. With depth
    and intr, a cloud in another depth unit is rescaled into the depth
    image's (config key `align_cloud_scale`). Returns (xyz (cap,3), mask
    (cap,)) on `device`."""
    xyz, _ = pcd_io.read_pcd(path)
    if align_scale and depth is not None and intr is not None:
        s = pointcloud.estimate_depth_scale(
            xyz, depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
        if s > 1.5 or s < 1 / 1.5:
            xyz = xyz / np.float32(s)
    n = xyz.shape[0]
    if n > cap:
        xyz = xyz[::-(-n // cap)]
        n = xyz.shape[0]
    xyz_p = np.zeros((cap, 3), np.float32)
    xyz_p[:n] = xyz
    mask = np.zeros(cap, bool)
    mask[:n] = True
    cloud = torch.from_numpy(xyz_p).to(device)
    m = pointcloud.passthrough_z(cloud, torch.from_numpy(mask).to(device), 0.0, z_max)
    vx, _, vm = pointcloud.voxel_downsample(cloud, torch.zeros_like(cloud), m, grid_leaf)
    return vx, vm


def register_normal(gray1, dep1, gray2, intr: CameraIntrinsics, detector: str,
                    descriptor: str, max_kp: int, u: torch.Tensor):
    """exp1_2's `Matching` on tensors: detect and describe both frames,
    match with the 5.0 floor, drop keypoints without depth, one RANSAC
    at 8 px over the (H,3) uniforms `u`. Returns (k1, k2, match indices,
    good mask, PnPResult)."""
    run = registry.detect_and_describe(detector, descriptor, max_kp)
    k1, d1 = run(gray1)
    k2, d2 = run(gray2)
    midx, mdist, mok = match_ops.match_nn(d1, k1.valid, d2, k2.valid)
    good = match_ops.good_match_filter(mdist, mok, floor=5.0)
    kp3d, has_depth = pipeline.compute_kp3d_drop(dep1, k1.uv, intr)
    good = good & has_depth
    res = pnp.solve_pnp_ransac(kp3d, k2.uv[midx], good, intr.fx, intr.fy, intr.cx, intr.cy,
                               u, reproj_thresh=8.0)
    return k1, k2, midx, good, res


def pose_inverse(rvec: torch.Tensor, tvec: torch.Tensor) -> np.ndarray:
    """The solved camera pose as T^-1, float64 on the host."""
    T = lie.make_T(lie.rodrigues(rvec), tvec).cpu().numpy().astype(np.float64)
    return se3.inverse(T)


def matching_normal(gray1, dep1, gray2, intr, detector, descriptor, max_kp, u):
    """Full-image pairwise registration (exp1_2 `Matching`) -> (T^-1,
    inliers)."""
    *_, res = register_normal(gray1, dep1, gray2, intr, detector, descriptor, max_kp, u)
    return pose_inverse(res.rvec, res.tvec), int(res.n_inliers)


def build_planar(intr, params: ParameterReader, detector: str, descriptor: str,
                 max_kp: int, hypotheses: int):
    """exp1_2's plane extractor and its multiPnP (no norm gate, no match
    floor, pooled RANSAC at `ransac_accuracy`)."""
    extract = pipeline.build_plane_extractor(
        detector, descriptor, intr, max_planes=params.get_int("max_planes"), max_kp=max_kp,
        dist_thresh=params.get_float("distance_threshold"),
        percent=params.get_float("plane_percent"), hypotheses=hypotheses)
    multipnp = pipeline.build_multipnp_planes(
        intr, error_threshold=1e9, pooled_reproj=params.get_float("ransac_accuracy"))
    return extract, multipnp


def matching_planar(frame1, frame2, intr, params, detector, descriptor, max_kp, hypotheses,
                    draws, timelog):
    """Plane-based pairwise registration (exp1_2 `MatchingPlanar`).

    frame1, frame2: (gray, depth, cloud, cloud mask) tensors; draws:
    (sampler of frame 1, sampler of frame 2, (P+2,H,3) PnP uniforms).
    Writes the stage rows to `timelog` and returns (T^-1, inliers)."""
    extract, multipnp = build_planar(intr, params, detector, descriptor, max_kp, hypotheses)
    sampler1, sampler2, u = draws
    device = frame1[0].device
    synchronize(device)
    t0 = time.perf_counter()
    f1 = extract(*frame1, sampler1)
    synchronize(device)
    n_planes = max(int(f1.plane_valid.sum()), 1)
    dt = (time.perf_counter() - t0) / n_planes
    timelog.write(f"ExtractPlane {dt:g}\n")
    # one fused extraction has no separable per-stage times: the fused
    # time stands under the remaining labels (schema of exp1_2.cpp:397-428)
    timelog.write(f"DetectKeypoints  {dt:g}\n")
    timelog.write(f"Descriptor  {dt:g}\n")
    timelog.write(f"Compute3dPosition {dt:g}\n")

    f2 = extract(*frame2, sampler2)
    synchronize(device)
    t0 = time.perf_counter()
    res = multipnp(f1, f2, u, 0)
    T = res.T.cpu().numpy().astype(np.float64)
    timelog.write(f"RANSAC {time.perf_counter() - t0:g}\n")
    return se3.inverse(T), int(res.inliers)


def planar_draws(params: ParameterReader, hypotheses: int, gen: torch.Generator):
    """Both extractions' samplers and the multiPnP's uniforms from `gen`."""
    sampler = plane_ransac.UniformSampler(gen)
    u = torch.rand((params.get_int("max_planes") + 2, hypotheses, 3), generator=gen,
                   device=gen.device)
    return sampler, sampler, u


def cloud_settings(params: ParameterReader, gray: np.ndarray):
    """(z limit, voxel leaf, capacity, align) as the reference reads them;
    the z limit comes from `optimize_step` (the reference's config slip)."""
    return (params.get_float("optimize_step"), params.get_float("grid_leaf"),
            params.get_int("cloud_capacity") or int(gray.size),
            params.get_bool("align_cloud_scale"))


def append_error(path: str, f1_idx: str, f2_idx: str, Tr: np.ndarray, T: np.ndarray,
                 inliers: int) -> None:
    """Prints the error and appends the row `f1 f2 gt_trans gt_rot
    err_trans err_rot inliers` to `path`."""
    Terr = se3.inverse(Tr) @ T
    err_trans = float(np.linalg.norm(Terr[:3, 3]))
    err_rot = error_angle(Terr)
    print(f"error: {err_trans}, {err_rot}")
    with open(path, "a") as f:
        f.write(f"{f1_idx} {f2_idx} {float(np.linalg.norm(Tr[:3, 3])):g} {error_angle(Tr):g} "
                f"{err_trans:g} {err_rot:g} {inliers}\n")


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

    gray1, dep1, g1, d1 = load_frame(ds, f1_idx, dev)
    _, dep2, g2, d2 = load_frame(ds, f2_idx, dev)
    Tr = ground_truth(ds, f1_idx, f2_idx)

    os.makedirs("./data/exp1", exist_ok=True)
    if mode == "n":
        u = torch.rand((hypotheses, 3), generator=gen, device=dev)
        T, inliers = matching_normal(g1, d1, g2, intr, detector, descriptor, max_kp, u)
    else:
        z_max, grid, cap, align = cloud_settings(params, gray1)
        c1 = load_cloud(os.path.join(ds, f"pcd/{f1_idx}.pcd"), z_max, grid, cap, dev,
                        dep1, intr, align)
        c2 = load_cloud(os.path.join(ds, f"pcd/{f2_idx}.pcd"), z_max, grid, cap, dev,
                        dep2, intr, align)
        with open("./data/time.log", "a") as timelog:
            T, inliers = matching_planar(
                (g1, d1, *c1), (g2, d2, *c2), intr, params, detector, descriptor, max_kp,
                hypotheses, planar_draws(params, hypotheses, gen), timelog)
    append_error("./data/exp1/error.log", f1_idx, f2_idx, Tr, T, inliers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
