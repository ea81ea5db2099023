"""Feature detector/descriptor behind the reference's config names (SIFT)."""

from .common import Keypoints  # noqa: F401
from .registry import create_descriptor, create_detector  # noqa: F401
