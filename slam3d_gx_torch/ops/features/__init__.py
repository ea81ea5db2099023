"""Feature detectors/descriptor behind the reference's config names
(SIFT, GFTT, HARRIS)."""

from .common import Keypoints  # noqa: F401
from .registry import create_descriptor, create_detector  # noqa: F401
