"""Detector/descriptor factory behind the reference's config names
(counterpart of slam3d_gx_tpu/ops/features/registry.py).

Carried: the detectors SIFT (DoG), GFTT (Shi-Tomasi, kernel K3 on the
card) and HARRIS, and the SIFT descriptor. Every other name of the
reference's zoo raises NotImplementedError naming the ROADMAP.md item
that ports it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from . import dog, harris, sift_desc
from .common import Keypoints, apply_mask

# names of the reference's zoo that later slices port (ROADMAP.md queue 1)
_LATER = {
    "SURF": "item 15 (detector and descriptor zoo)",
    "SURF_SIFT": "item 15 (detector and descriptor zoo)",
    "SURF-SIFT": "item 15 (detector and descriptor zoo)",
    "STAR": "item 15 (detector and descriptor zoo)",
    "FAST": "item 15 (detector and descriptor zoo)",
    "GRIDFAST": "item 15 (detector and descriptor zoo)",
    "ORB": "item 15 (detector and descriptor zoo)",
    "BRIEF": "item 15 (detector and descriptor zoo)",
}


def _unsupported(kind: str, name: str):
    key = name.strip().upper()
    if key in _LATER:
        return NotImplementedError(
            f"{kind} {name!r} is not ported yet: ROADMAP.md queue 1 {_LATER[key]}")
    return ValueError(f"unknown {kind} name: {name!r}")


def create_detector(name: str, max_kp: int = 512) -> Callable[..., Keypoints]:
    """Returns detect(img, mask=None) -> Keypoints."""
    key = name.strip().upper()
    if key == "SIFT":
        base = functools.partial(dog.detect_sift, max_kp=max_kp)
    elif key == "GFTT":
        base = functools.partial(harris.detect_gftt, max_kp=max_kp)
    elif key == "HARRIS":
        base = functools.partial(harris.detect_gftt, max_kp=max_kp, use_harris=True)
    else:
        raise _unsupported("detector", name)

    def detect(img, mask: Optional[torch.Tensor] = None) -> Keypoints:
        kps = base(img)
        if mask is not None:
            kps = apply_mask(kps, mask)
        return kps

    return detect


def create_descriptor(name: str):
    """Returns describe(img, kps) -> (K,128) float32 descriptors."""
    if name.strip().upper() != "SIFT":
        raise _unsupported("descriptor", name)
    return sift_desc.sift_descriptors


def match_floor(descriptor_name: str) -> float:
    """Distance floor for the 3*min_dist good-match gate: 0 for the
    SIFT family (the reference's no-floor behavior), 5.0 for binary
    descriptors (the reference's exp1 floor)."""
    if descriptor_name.strip().upper() in ("ORB", "BRIEF"):
        return 5.0
    return 0.0
