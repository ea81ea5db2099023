"""Detector/descriptor factory behind the reference's config names
(counterpart of slam3d_gx_tpu/ops/features/registry.py).

cv::FeatureDetector::create / DescriptorExtractor::create as the
reference calls them (src/GraphicEnd.cpp:63-65). Names:

  SIFT      -> DoG detector / 128-d SIFT descriptor
  SURF      -> fast-Hessian box-filter detector (surf.py) / 64-d SURF
               descriptor (surf_desc.py); SURF_SIFT and SURF-SIFT select
               the SIFT descriptor
  GFTT      -> Shi-Tomasi (kernel K3 on the card); HARRIS -> Harris
  FAST      -> FAST-9/16; GRIDFAST -> grid-budgeted FAST (fast.py)
  STAR      -> CenSurE bi-level center-surround detector (star.py)
  ORB       -> grid FAST detector / 256-bit rotated-BRIEF descriptor
               (orb.py; BRIEF names the same descriptor)

The JAX package's `unbatched` flag of create_detector only picks a
Pallas layout for GFTT; here GFTT always launches K3 for an image on
the card, so the flag does not exist.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from . import dog, fast, harris, orb, sift_desc, star, surf, surf_desc
from .common import Keypoints, apply_mask


def create_detector(name: str, max_kp: int = 512) -> Callable[..., Keypoints]:
    """Returns detect(img, mask=None) -> Keypoints."""
    bases = {
        "SIFT": dog.detect_sift,
        "SURF": surf.detect_surf,
        "STAR": star.detect_star,
        "GFTT": harris.detect_gftt,
        "HARRIS": functools.partial(harris.detect_gftt, use_harris=True),
        "FAST": fast.detect_fast,
        "GRIDFAST": fast.detect_grid_fast,
        "ORB": fast.detect_grid_fast,
    }
    key = name.strip().upper()
    if key not in bases:
        raise ValueError(f"unknown detector name: {name!r}")
    base = functools.partial(bases[key], max_kp=max_kp)

    def detect(img, mask: Optional[torch.Tensor] = None) -> Keypoints:
        kps = base(img)
        if mask is not None:
            kps = apply_mask(kps, mask)
        return kps

    return detect


def create_descriptor(name: str):
    """Returns describe(img, kps) -> (K, descriptor_dim(name)) float32."""
    key = name.strip().upper()
    if key in ("SIFT", "SURF_SIFT", "SURF-SIFT"):
        return sift_desc.sift_descriptors
    if key == "SURF":
        return surf_desc.surf_descriptors
    if key in ("ORB", "BRIEF"):
        return orb.orb_descriptors
    raise ValueError(f"unknown descriptor name: {name!r}")


def descriptor_dim(descriptor_name: str) -> int:
    """The D of the (K,D) descriptors create_descriptor's function returns."""
    key = descriptor_name.strip().upper()
    if key == "SURF":
        return 64
    if key in ("ORB", "BRIEF"):
        return orb.N_BITS
    return 128


def match_floor(descriptor_name: str) -> float:
    """Distance floor for the 3*min_dist good-match gate: 0 for the
    float descriptors (the reference's no-floor behavior), 5.0 for the
    binary ones, where one exact match would collapse the bound to zero
    (the reference's exp1 floor, src/exp1/exp1.cpp:315-321)."""
    if descriptor_name.strip().upper() in ("ORB", "BRIEF"):
        return 5.0
    return 0.0


def detect_and_describe(detector_name: str, descriptor_name: str, max_kp: int = 512):
    """Returns run(img, mask=None) -> (Keypoints, (K,D) descriptors)."""
    det = create_detector(detector_name, max_kp)
    desc = create_descriptor(descriptor_name)

    def run(img, mask=None):
        kps = det(img, mask)
        return kps, desc(img, kps)

    return run
