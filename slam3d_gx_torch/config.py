"""Configuration: the reference's 25-knob YAML surface plus camera intrinsics.

Parity target: ParameterReader (reference src/ParameterReader.{h,cpp}) — a
global singleton that parses ./parameters.yaml once and serves every knob as
a *string* via GetPara(name); camera intrinsics become globals
(reference src/ParameterReader.cpp:9,55-59, src/const.h:20).

The reference file uses the OpenCV-YAML dialect (leading `%YAML:1.0`
directive) that standard YAML parsers reject, so we parse the degenerate
`key: value` grammar directly and accept both dialects.

TPU-native deltas:
- intrinsics are carried in an immutable CameraIntrinsics value (handed to
  kernels as scalars) instead of mutable globals;
- an explicit `seed` knob replaces the reference's srand(time(0))
  (src/GraphicEnd.cpp:69) so loop-closure sampling is reproducible;
- typed accessors exist alongside the string-typed GetPara for parity.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

# The 25 reference keys (reference parameters.yaml:6-98, read at
# src/ParameterReader.cpp:28-66) + camera intrinsics.
REFERENCE_KEYS = (
    "data_source",
    "detector_name",
    "descriptor_name",
    "start_index",
    "end_index",
    "match_min_dist",
    "step_time",
    "optimize_step",
    "robust_kernel",
    "max_pos_change",
    "grid_leaf",
    "error_threshold",
    "distance_threshold",
    "plane_percent",
    "min_error_plane",
    "max_planes",
    "loop_closure_detection",
    "loopclosure_frames",
    "loop_closure_error",
    "loop_closure_inliers",
    "ransac_accuracy",
    "lost_frames",
    "use_odometry",
    "error_odometry",
    "z_filter",
)

INTRINSIC_KEYS = (
    "camera_fx",
    "camera_fy",
    "camera_cx",
    "camera_cy",
    "camera_factor",
)

# Defaults mirror the active (fr1) block of the reference parameters.yaml.
DEFAULTS: Dict[str, str] = {
    "data_source": "./data",
    "detector_name": "SIFT",
    "descriptor_name": "SIFT",
    "start_index": "1",
    "end_index": "2800",
    "match_min_dist": "5",
    "step_time": "10",
    "optimize_step": "200",
    "robust_kernel": "Cauchy",
    "max_pos_change": "0.25",
    "grid_leaf": "0.03",
    "error_threshold": "1.0",
    "distance_threshold": "0.08",
    "plane_percent": "0.2",
    "min_error_plane": "0.02",
    "max_planes": "3",
    "loop_closure_detection": "yes",
    "loopclosure_frames": "30",
    "loop_closure_error": "1.5",
    "loop_closure_inliers": "30",
    "ransac_accuracy": "8.0",
    "lost_frames": "10",
    "use_odometry": "no",
    "error_odometry": "0.03",
    "z_filter": "7.0",
    # fr1 preset (reference parameters.yaml:82-86)
    "camera_fx": "517.0",
    "camera_fy": "517.0",
    "camera_cx": "318.6",
    "camera_cy": "255.3",
    "camera_factor": "5000.0",
    # framework-only knobs (not in the reference surface)
    "seed": "0",
    "max_keypoints": "512",
    "ransac_hypotheses": "256",
    # 1 = verify all loop-closure/recovery candidates in one batched
    # device launch (parallel/registration.py); 0 = reference-style
    # sequential per-candidate checks
    "loop_closure_batched": "1",
    # 1 = draw loop-closure candidates from the sharded keyframe
    # database ranked by descriptor-match score (parallel/lcdb.py);
    # 0 (default) = the reference's uniform random draws
    "loop_closure_scored": "0",
    # fixed point capacity the raw cloud is padded to before the jitted
    # extract (one shape per dataset, no per-frame re-jit; CLAUDE.md:
    # remote compiles are 1-6 min per distinct shape). 0 = auto (H*W of
    # the first frame). Larger clouds are stride-decimated to fit.
    "cloud_capacity": "0",
    # 1 = restore the reference's VoxelGrid(grid_leaf) downsample of the
    # cloud before plane RANSAC (src/GraphicEnd.cpp:287-295); 0 (default)
    # = the extractor's strided decimation, under which grid_leaf is
    # inert in the plane path (it still drives saveOutput fusion).
    "voxel_downsample_clouds": "0",
    # PnP refinement: "tiered" (default; skip/shorten the Gauss-Newton
    # polish where only inlier masks or a seed pose are consumed) or
    # "full" (uniform 10-iteration polish, round-1 behavior)
    "pnp_refine_mode": "tiered",
    # plane coverage images: "membership" (analytic image-space test,
    # TPU-native default) or "splat" (the reference's point splatting
    # with depth-adaptive blocks, src/GraphicEnd.cpp:390-420)
    "plane_image_mode": "membership",
    # global detection budget for detect_scope=frame; 0 (default) =
    # max_keypoints shared across planes (fastest, quality-validated);
    # set max_planes*max_keypoints for per-plane budget parity
    "frame_kp_budget": "0",
    # "frame" (TPU-native default) = equalize/detect/describe once per
    # frame and assign keypoints to planes by coverage membership (one
    # scale-space pyramid instead of max_planes); "plane" = the
    # reference's per-plane equalizeHist + masked detection
    # (src/GraphicEnd.cpp:128-134), ~3x the detector/descriptor work
    "detect_scope": "frame",
    # 1 (default) = rescale loaded PCD clouds into depth units when the
    # two disagree by >1.5x (the reference's convert2PCD writes
    # factor-1000 clouds while the fr1 preset reads depth at 5000 and
    # silently mixes the unit systems, src/convert2PCD.cpp:19-23 vs
    # parameters.yaml:86); 0 = raw reference behavior
    "align_cloud_scale": "1",
    # loop-closure consistency gate: reject an accepted loop edge when
    # its measured relative translation deviates from the frontend's
    # running-pose prediction by more than this many meters. 0
    # (default) = off, reference parity (the reference gates only on
    # norm/inliers, src/GraphicEnd.cpp:739-760). Turn on (e.g. 0.5) in
    # scenes with repeated structure: the lc_audit harness measured a
    # 1.8% false-accept class with ~1.3 m error from perceptual
    # aliasing that norm/inlier gates cannot see, while real drift at
    # this scale is centimeters. Leave off when expected odometry drift
    # between revisits approaches the gate.
    "loop_closure_max_drift": "0",
    # multi-device: 0 (default) = one device, no mesh; N = a (dp, sp)
    # mesh over the N ranks of the process group, one process a card
    # (torchrun --nproc-per-node N; parallel/mesh.py; 1 without a group
    # starts a one-rank group), and the application runs sharded —
    # loop-closure/recovery candidate verification fans out over dp, the
    # scored keyframe database shards over sp, and the finalize
    # pose-graph solve shards its edge set over dp; -1 = every rank of
    # the group (no mesh with one rank or no group). The reference
    # workloads these shard: the 30-candidate loop round
    # (src/GraphicEnd.cpp:729-761), the O(K) recovery scan (:810-836),
    # and optimize(200) (:669-670).
    "mesh_devices": "0",
    # finalize walk-candidate pre-filter: 0 (default) = exact reference
    # semantics — findMoreLoops' bulk scan registers each connected
    # source against the WHOLE keyframe history (O(S*K) multiPnP
    # pairs). N>0 = rank the history by the lcdb retrieval score first
    # and full-multiPnP only the top N per source; pruned pairs are
    # cached as failed verdicts (the walk stops there, as at a failed
    # registration). Bounds finalize cost at 500+ keyframes; verified
    # edge-set-equivalent at reference scale in tests/test_e2e.py.
    "finalize_prefilter": "0",
    # streaming pipeline depth: chunks decoded+uploaded ahead of the
    # device scan by the background loader (frontend/streaming.py).
    # 2 keeps one chunk decoding while another uploads, both hidden
    # behind the scan; 0 disables the pipeline entirely (synchronous
    # load -> dispatch -> apply per chunk — the overlap-off baseline
    # benchmarks compare against).
    "streaming_prefetch_chunks": "2",
}

# Intrinsics preset blocks the reference ships commented out
# (parameters.yaml:69-98) plus convert2PCD's hardcoded defaults
# (src/convert2PCD.cpp:19-23).
INTRINSICS_PRESETS: Dict[str, Dict[str, float]] = {
    "fr1": dict(fx=517.0, fy=517.0, cx=318.6, cy=255.3, factor=5000.0),
    "fr2": dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7, factor=5000.0),
    "fr3": dict(fx=535.9, fy=539.2, cx=320.1, cy=247.6, factor=5000.0),
    "default": dict(fx=525.0, fy=525.0, cx=319.5, cy=235.5, factor=1000.0),
    "my_robot": dict(fx=535.147, fy=535.04, cx=297.25, cy=247.91, factor=1000.0),
}


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model constants (reference src/const.h:20)."""

    fx: float
    fy: float
    cx: float
    cy: float
    factor: float  # raw uint16 depth -> meters divisor

    @staticmethod
    def preset(name: str) -> "CameraIntrinsics":
        return CameraIntrinsics(**INTRINSICS_PRESETS[name])


def _parse_kv_yaml(text: str) -> Dict[str, str]:
    """Parse the flat `key: value` grammar of both YAML dialects.

    Tolerates the OpenCV `%YAML:1.0` directive, full-line and trailing
    `#` comments, and blank lines — the exact shape of the reference file.
    """
    out: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("%"):
            continue
        if ":" not in line:
            continue
        key, _, value = line.partition(":")
        value = value.split("#", 1)[0].strip().strip('"').strip("'")
        key = key.strip()
        if key:
            out[key] = value
    return out


class ParameterReader:
    """String-typed config access with the reference's GetPara surface.

    Reference: src/ParameterReader.cpp:11-123. Unknown keys raise KeyError
    (the reference prints an error and returns ""); knobs absent from the
    file fall back to the reference defaults so partial files work.
    """

    def __init__(self, path: Optional[str] = None, overrides: Optional[Dict[str, str]] = None):
        self.values: Dict[str, str] = dict(DEFAULTS)
        self.path = path
        if path is not None and os.path.exists(path):
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                self.values.update(_parse_kv_yaml(f.read()))
        if overrides:
            self.values.update({k: str(v) for k, v in overrides.items()})
        # reference validates start_index < end_index (src/ParameterReader.cpp:37-41)
        if self.get_int("start_index") >= self.get_int("end_index"):
            raise ValueError("start_index must be < end_index")

    # -- reference-parity accessor ------------------------------------
    def GetPara(self, name: str) -> str:  # noqa: N802 (parity name)
        if name not in self.values:
            raise KeyError(f"parameter {name!r} not found")
        return self.values[name]

    # -- typed conveniences --------------------------------------------
    def get_str(self, name: str) -> str:
        return self.GetPara(name)

    def get_int(self, name: str) -> int:
        return int(float(self.GetPara(name)))

    def get_float(self, name: str) -> float:
        return float(self.GetPara(name))

    def get_bool(self, name: str) -> bool:
        return self.GetPara(name).strip().lower() in ("yes", "true", "1", "on")

    @property
    def intrinsics(self) -> CameraIntrinsics:
        return CameraIntrinsics(
            fx=self.get_float("camera_fx"),
            fy=self.get_float("camera_fy"),
            cx=self.get_float("camera_cx"),
            cy=self.get_float("camera_cy"),
            factor=self.get_float("camera_factor"),
        )


def load(path: Optional[str] = "./parameters.yaml", **overrides) -> ParameterReader:
    return ParameterReader(path, overrides={k: str(v) for k, v in overrides.items()})
