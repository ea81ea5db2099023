"""Per-frame compute: feature extraction and multiPnP
(counterpart of slam3d_gx_tpu/frontend/pipeline.py).

- plane-frame extraction mirrors extractPlanesAndGenerateImage + the
  per-plane keypoints / descriptors / compute3dPosition of the reference
  (src/GraphicEnd.cpp:128-134, 353-457): in frame scope (the default) one
  equalize + detect + describe pass per frame, keypoints assigned to
  planes by their coverage masks; in plane scope the reference's pass
  per plane;
- image-frame extraction mirrors GraphicEnd2::extractKPandDesp and its
  zero-depth-dropping compute3dPosition (src/GraphicEnd2.cpp:203-233);
- multipnp_planes follows GraphicEnd::multiPnP step for step
  (src/GraphicEnd.cpp:557-659): plane match -> per-pair pnp inliers
  pooled -> global RANSAC(8px) -> inlier gate -> re-RANSAC(3px,
  extrinsic guess) -> norm gate; failure returns Identity;
- multipnp_image follows GraphicEnd2::multiPnP (src/GraphicEnd2.cpp:
  235-312): single match -> RANSAC(8px) -> inlier gate -> norm gate, no
  second solve.

Random draws are arguments: the extractor takes a plane sampler
(ops/plane_ransac.py), multipnp_planes the (P+2,H,3) PnP uniforms, one
(H,3) block per solve in the reference's key-split order (P per-plane
solves, the pooled solve, the 3px re-solve), multipnp_image one (H,3)
block.

Both multiPnP functions also take a batch of pairs: FrameFeatures with
a leading axis B on every field and uniforms with the same leading
axis. The B pairs then run as one batch of tensor operations (the
reference vmaps the single-pair function), which is what the batched
loop-closure verifier (parallel/registration.py) calls.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..config import CameraIntrinsics
from ..ops import imageproc, lie, match, plane_ransac, pnp, pointcloud
from ..ops.features import registry
from ..ops.features.common import pixel_index, top_k
from .state import FrameFeatures, MultiPnPResult

# point budget the plane-RANSAC stage decimates the cloud to
PLANE_POINTS = 8192
# farthest depth (m) a pixel may have to join a plane's membership image
Z_MAX = 7.0
# reprojection threshold (px) of the pooled solve (src/GraphicEnd.cpp:595)
# and of the image path's one solve
POOLED_REPROJ = 8.0


def compute_kp3d_plane(depth, uv, coeff, intr: CameraIntrinsics):
    """Pinhole backprojection of keypoints (...,K,2) with plane coeff
    (...,4); zero-depth keypoints fall back to the plane-ray intersection
    (reference src/GraphicEnd.cpp:440-455). Depth is read at the rounded
    pixel (src/GraphicEnd.cpp:438)."""
    u, v = pixel_index(uv, *depth.shape)
    d = depth[v, u].to(torch.float32)
    k1 = (uv[..., 0] - intr.cx) / intr.fx
    k2 = (uv[..., 1] - intr.cy) / intr.fy
    z_meas = d / intr.factor
    a, b, c, e = (coeff[..., i, None] for i in range(4))
    denom = a * k1 + b * k2 + c
    z_plane = -e / torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
    z = torch.where(d > 0, z_meas, z_plane)
    return (torch.stack([k1 * z, k2 * z, z], dim=-1),
            torch.ones(uv.shape[:-1], dtype=torch.bool, device=uv.device))


def compute_kp3d_drop(depth, uv, intr: CameraIntrinsics):
    """GraphicEnd2 variant: zero-depth keypoints are dropped
    (src/GraphicEnd2.cpp:221-225). Returns kp3d (...,K,3) and the
    has-depth mask (...,K)."""
    u, v = pixel_index(uv, *depth.shape)
    d = depth[v, u].to(torch.float32)
    z = d / intr.factor
    k1 = (uv[..., 0] - intr.cx) / intr.fx
    k2 = (uv[..., 1] - intr.cy) / intr.fy
    return torch.stack([k1 * z, k2 * z, z], dim=-1), d > 0


def build_plane_extractor(
    detector_name: str,
    descriptor_name: str,
    intr: CameraIntrinsics,
    max_planes: int = 3,
    max_kp: int = 512,
    dist_thresh: float = 0.08,
    percent: float = 0.2,
    hypotheses: int = 256,
    plane_image_mode: str = "membership",
    detect_scope: str = "frame",
    frame_kp_budget: int = 0,
) -> Callable:
    """Returns extract(gray, depth, cloud_xyz, cloud_mask, sampler) ->
    FrameFeatures with P = max_planes.

    The plane fit sees a strided decimation of the cloud to
    PLANE_POINTS points over its fixed capacity.

    plane_image_mode (config key `plane_image_mode`): "membership"
    computes each plane's coverage image from the plane equation at full
    resolution; "splat" paints the decimated cloud's inliers with the
    reference's depth-adaptive squares (src/GraphicEnd.cpp:390-420,
    `imageproc.splat_plane_image`).

    detect_scope (config key `detect_scope`): "frame" equalizes, detects
    and describes once on the whole frame and gives each plane its
    top-max_kp member keypoints (frame_kp_budget detections in all, 0 =
    max_kp); "plane" is the reference's per-plane pass
    (src/GraphicEnd.cpp:128-134, GraphicEnd.h:97-111): for each of the
    P slots, equalizeHist of that plane's image, the detector restricted
    to its mask, the descriptor on the full gray frame. The P slots run
    one after the other, so on the card each extraction launches
    `equalize_hist256` P times, and K3 P times with GFTT. The JAX
    package takes GFTT's plain XLA response on this path (it vmaps the
    slots); K3 computes the same function, held to that plain version
    by its own tests.
    """
    if plane_image_mode not in ("membership", "splat"):
        raise ValueError(f"plane_image_mode: {plane_image_mode!r}")
    if detect_scope not in ("frame", "plane"):
        raise ValueError(f"detect_scope: {detect_scope!r}")
    budget = (frame_kp_budget or max_kp) if detect_scope == "frame" else max_kp
    detect = registry.create_detector(detector_name, budget)
    describe = registry.create_descriptor(descriptor_name)

    def plane_images(gray, depth, dxyz, plane_masks, coeffs, valids):
        if plane_image_mode == "splat":
            H, W = gray.shape
            return imageproc.splat_plane_image(
                dxyz, plane_masks & valids[:, None], gray, intr.fx, intr.fy,
                intr.cx, intr.cy, height=H, width=W)
        xyz_img, valid_img = pointcloud.backproject(
            depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
        z = xyz_img[..., 2]
        valid_img = valid_img & (z > 0) & (z <= Z_MAX)
        return imageproc.plane_membership_images(
            xyz_img, valid_img, coeffs, valids, gray, dist_thresh)

    def frame_scope(gray, depth, masks, coeffs, valids):
        # one pyramid + one descriptor pass for the whole frame; each
        # plane keeps its own top-max_kp member keypoints by response
        kps = detect(imageproc.equalize_hist(gray).to(torch.float32))
        desc1 = describe(gray, kps)
        ui, vi = pixel_index(kps.uv, *gray.shape)
        in_plane = masks[:, vi, ui]  # (P,Kg)
        score = torch.where(in_plane & kps.valid & valids[:, None],
                            kps.response, -torch.inf)
        k_eff = min(max_kp, score.shape[1])
        vals, idx = top_k(score, k_eff)
        uv, desc = kps.uv[idx], desc1[idx]
        if k_eff < max_kp:
            # a budget below max_kp cannot fill a plane: pad invalid
            pad = max_kp - k_eff
            vals = F.pad(vals, (0, pad), value=-torch.inf)
            uv = F.pad(uv, (0, 0, 0, pad))
            desc = F.pad(desc, (0, 0, 0, pad))
        kp3d, v3 = compute_kp3d_plane(depth, uv, coeffs, intr)
        return uv, kp3d, desc, (vals > -torch.inf) & v3

    def plane_scope(gray, depth, images, masks, coeffs, valids):
        out = []
        for p in range(coeffs.shape[0]):
            kps = detect(imageproc.equalize_hist(images[p]), masks[p])
            kps = kps._replace(valid=kps.valid & valids[p])
            desc = describe(gray, kps)
            kp3d, v3 = compute_kp3d_plane(depth, kps.uv, coeffs[p], intr)
            out.append((kps.uv, kp3d, desc, kps.valid & v3))
        return (torch.stack(f) for f in zip(*out))

    def extract(gray, depth, cloud_xyz, cloud_mask, sampler) -> FrameFeatures:
        stride = max(1, cloud_xyz.shape[0] // PLANE_POINTS)
        dxyz = cloud_xyz[::stride][:PLANE_POINTS]
        coeffs, plane_masks, valids, _ = plane_ransac.extract_planes(
            dxyz, cloud_mask[::stride][:PLANE_POINTS],
            sampler, max_planes=max_planes, dist_thresh=dist_thresh,
            percent=percent, hypotheses=hypotheses)
        images, masks = plane_images(gray, depth, dxyz, plane_masks, coeffs, valids)
        if detect_scope == "frame":
            uv, kp3d, desc, kpv = frame_scope(gray, depth, masks, coeffs, valids)
        else:
            uv, kp3d, desc, kpv = plane_scope(gray, depth, images, masks, coeffs, valids)
        return FrameFeatures(coeffs=coeffs, plane_valid=valids, uv=uv, kp3d=kp3d,
                             desc=desc, kp_valid=kpv)

    return extract


def build_image_extractor(detector_name: str, descriptor_name: str,
                          intr: CameraIntrinsics, max_kp: int = 512) -> Callable:
    """GraphicEnd2 path: the whole image is one pseudo-plane
    (src/GraphicEnd2.cpp:133,156,203-212). Returns extract(gray, depth)
    -> FrameFeatures with P = 1 and zero coefficients.

    Detection runs on the raw gray image; keypoints without depth are
    dropped before the descriptor pass, so their descriptors never count
    as valid in the matcher."""
    detect = registry.create_detector(detector_name, max_kp)
    describe = registry.create_descriptor(descriptor_name)

    def extract(gray, depth) -> FrameFeatures:
        kps = detect(gray)
        kp3d, has_depth = compute_kp3d_drop(depth, kps.uv, intr)
        kps = kps._replace(valid=kps.valid & has_depth)
        desc = describe(gray, kps)
        dev = kps.uv.device
        return FrameFeatures(
            coeffs=torch.zeros((1, 4), dtype=torch.float32, device=dev),
            plane_valid=torch.ones((1,), dtype=torch.bool, device=dev),
            uv=kps.uv[None], kp3d=kp3d[None], desc=desc[None], kp_valid=kps.valid[None])

    return extract


def _finish(rvec, tvec, norm, inliers, accept) -> MultiPnPResult:
    T = lie.make_T(lie.rodrigues(rvec), tvec)
    T = torch.where(accept[..., None, None], T,
                    torch.eye(4, dtype=T.dtype, device=T.device))
    return MultiPnPResult(T=T, norm=norm, inliers=inliers, ok=accept)


def _as_batch(fa: FrameFeatures, fb: FrameFeatures, u: torch.Tensor):
    """A single pair gets a leading batch axis of 1; returns (fa, fb, u,
    whether it was single)."""
    single = fa.uv.dim() == 3
    if single:
        fa = FrameFeatures(*(x[None] for x in fa))
        fb = FrameFeatures(*(x[None] for x in fb))
        u = u[None]
    return fa, fb, u, single


def _pose_norm_parts(res):
    rn = torch.linalg.vector_norm(res.rvec, dim=-1)
    tn = torch.linalg.vector_norm(res.tvec, dim=-1)
    return torch.minimum(rn, 2 * math.pi - rn), tn


def build_multipnp_planes(
    intr: CameraIntrinsics,
    error_threshold: float = 1.0,
    match_floor: float = 0.0,
    pooled_reproj: float = POOLED_REPROJ,
    refine_mode: str = "tiered",
) -> Callable:
    """GraphicEnd::multiPnP (src/GraphicEnd.cpp:557-659).

    Returns multipnp(fa, fb, u, minimum_inliers) with u (P+2, H, 3)
    uniforms: H hypotheses for each of the P per-plane solves, the pooled
    solve and the 3 px solve. With a leading batch axis B on the features
    and on u, the B pairs are registered together and every field of the
    result has that axis.

    pooled_reproj: px threshold of the pooled RANSAC, 8 in the frontend
    (src/GraphicEnd.cpp:595); exp1_2's MatchingPlanar reads it from
    `ransac_accuracy` (exp1_2.cpp:465-467).

    refine_mode (config key `pnp_refine_mode`): "tiered" (default) skips
    the Gauss-Newton polish in the per-plane solves (only their inlier
    masks are used) and shortens it to 4 steps in the pooled solve (its
    pose only seeds the 3px solve); "full" polishes 10 steps everywhere.
    """
    if refine_mode not in ("tiered", "full"):
        raise ValueError(f"refine_mode: {refine_mode!r}")
    plane_iters = 0 if refine_mode == "tiered" else 10
    pooled_iters = 4 if refine_mode == "tiered" else 10
    cam = (intr.fx, intr.fy, intr.cx, intr.cy)

    def multipnp(fa: FrameFeatures, fb: FrameFeatures, u: torch.Tensor,
                 minimum_inliers) -> MultiPnPResult:
        fa, fb, u, single = _as_batch(fa, fb, u)
        B, P, K = fa.uv.shape[:3]
        bi = torch.arange(B, device=fa.uv.device)[:, None]
        # plane match by (a,b,c,d) coefficients (src/GraphicEnd.cpp:561)
        pidx, _, pvalid = match.match_planes(
            fa.coeffs, fa.plane_valid, fb.coeffs, fb.plane_valid)

        # per-plane-pair matching + pnp, the B*P pairs as one batch; only
        # their inlier masks are pooled (src/GraphicEnd.cpp:572-595)
        midx, mdist, mok = match.match_nn(fa.desc, fa.kp_valid, fb.desc[bi, pidx],
                                          fb.kp_valid[bi, pidx])
        good = match.good_match_filter(mdist, mok, floor=match_floor) & pvalid[..., None]
        img = torch.gather(fb.uv[bi, pidx], 2, midx[..., None].expand(B, P, K, 2))
        res_p = pnp.solve_pnp_ransac(
            fa.kp3d.reshape(B * P, K, 3), img.reshape(B * P, K, 2),
            good.reshape(B * P, K), *cam, u[:, :P].reshape(B * P, -1, 3),
            reproj_thresh=8.0, refine_iters=plane_iters)

        obj = fa.kp3d.reshape(B, P * K, 3)
        img = img.reshape(B, P * K, 2)
        pooled = (res_p.inliers & res_p.ok[:, None]).reshape(B, P * K)

        # global RANSAC at pooled_reproj px (src/GraphicEnd.cpp:595)
        res1 = pnp.solve_pnp_ransac(obj, img, pooled, *cam, u[:, P],
                                    reproj_thresh=pooled_reproj,
                                    refine_iters=pooled_iters)
        n1 = res1.n_inliers
        have_any = pooled.sum(dim=-1) >= 3

        # refine on inliers at 3px with extrinsic guess (src/GraphicEnd.cpp:615)
        res2 = pnp.solve_pnp_ransac(obj, img, res1.inliers, *cam, u[:, P + 1],
                                    reproj_thresh=3.0, guess_rvec=res1.rvec,
                                    guess_tvec=res1.tvec)

        rot, tn = _pose_norm_parts(res2)
        norm = torch.abs(rot) + 0.9 * torch.abs(tn)
        enough = (n1 >= minimum_inliers) & res1.ok & have_any
        accept = enough & (norm <= error_threshold) & res2.ok
        # the reference reports norm/inliers even when gated
        # (src/GraphicEnd.cpp:620-624)
        out = _finish(res2.rvec, res2.tvec, torch.where(enough, norm, 0.0), n1, accept)
        return MultiPnPResult(*(a[0] for a in out)) if single else out

    return multipnp


def build_multipnp_image(intr: CameraIntrinsics, error_threshold: float = 1.0,
                         match_floor: float = 0.0) -> Callable:
    """GraphicEnd2::multiPnP (src/GraphicEnd2.cpp:235-312): the single
    pseudo-plane, one RANSAC at 8 px with the full polish, the inlier
    gate, the norm |min(rn, 2pi - rn) + tn|, no second solve.

    Returns multipnp(fa, fb, u, minimum_inliers) with u (H, 3) uniforms,
    or (B, H, 3) for a batch of B pairs (see build_multipnp_planes)."""
    cam = (intr.fx, intr.fy, intr.cx, intr.cy)

    def multipnp(fa: FrameFeatures, fb: FrameFeatures, u: torch.Tensor,
                 minimum_inliers) -> MultiPnPResult:
        fa, fb, u, single = _as_batch(fa, fb, u)
        B, _, K = fa.uv.shape[:3]
        midx, mdist, mok = match.match_nn(fa.desc[:, 0], fa.kp_valid[:, 0],
                                          fb.desc[:, 0], fb.kp_valid[:, 0])
        good = match.good_match_filter(mdist, mok, floor=match_floor)
        img = torch.gather(fb.uv[:, 0], 1, midx[..., None].expand(B, K, 2))
        res = pnp.solve_pnp_ransac(fa.kp3d[:, 0], img, good, *cam, u,
                                   reproj_thresh=POOLED_REPROJ)
        rot, tn = _pose_norm_parts(res)
        norm = torch.abs(rot + tn)
        enough = (res.n_inliers >= minimum_inliers) & res.ok & (good.sum(dim=-1) > 0)
        accept = enough & (norm <= error_threshold)
        out = _finish(res.rvec, res.tvec, torch.where(enough, norm, 0.0),
                      res.n_inliers, accept)
        return MultiPnPResult(*(a[0] for a in out)) if single else out

    return multipnp
