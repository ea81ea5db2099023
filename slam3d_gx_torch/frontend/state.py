"""Frontend world model: fixed-shape, masked feature containers
(counterpart of slam3d_gx_tpu/frontend/state.py).

The reference's PLANE / KEYFRAME / RESULT_OF_MULTIPNP structs
(src/GraphicEnd.h:41-69): ragged per-plane keypoint vectors become
(P, K, ...) padded stacks with validity masks.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch


class FrameFeatures(NamedTuple):
    """All planes of one frame (P = max_planes).

    coeffs: (P,4) plane [a,b,c,d]; plane_valid: (P,);
    uv: (P,K,2) keypoint pixels; kp3d: (P,K,3) backprojected positions;
    desc: (P,K,D) descriptors; kp_valid: (P,K).
    """

    coeffs: torch.Tensor
    plane_valid: torch.Tensor
    uv: torch.Tensor
    kp3d: torch.Tensor
    desc: torch.Tensor
    kp_valid: torch.Tensor


class MultiPnPResult(NamedTuple):
    """RESULT_OF_MULTIPNP analog (reference src/GraphicEnd.h:59-69); the
    reference's failure sentinel T == Identity is carried as `ok`."""

    T: torch.Tensor        # (4,4)
    norm: torch.Tensor     # ()
    inliers: torch.Tensor  # () int
    ok: torch.Tensor       # () bool


@dataclasses.dataclass
class Keyframe:
    """KEYFRAME analog (reference src/GraphicEnd.h:51-57), host-side."""

    id: int
    frame_index: int
    features: FrameFeatures
    connect: List[int] = dataclasses.field(default_factory=list)


def pack_result(res: MultiPnPResult) -> torch.Tensor:
    """Flatten a result into one (...,19) fp32 tensor: T (16), norm,
    inliers, ok — so the host pays one device-to-host copy per result,
    or per batch of results."""
    tail = torch.stack([res.norm.to(torch.float32), res.inliers.to(torch.float32),
                        res.ok.to(torch.float32)], dim=-1)
    return torch.cat([res.T.reshape(res.T.shape[:-2] + (16,)).to(torch.float32), tail],
                     dim=-1)


def unpack_result_row(row: np.ndarray):
    """One packed (19,) host row -> (np 4x4 T float64, float norm, int
    inliers, bool ok)."""
    return (row[:16].astype(np.float64).reshape(4, 4), float(row[16]),
            int(row[17]), bool(row[18] != 0.0))


def result_to_host(res: MultiPnPResult):
    """Device result -> (np 4x4 T float64, float norm, int inliers, bool
    ok), with one `.cpu()` of the packed row."""
    return unpack_result_row(pack_result(res).cpu().numpy())
