"""Feature detectors/descriptors behind the reference's config names
(SIFT, SURF, STAR, GFTT, HARRIS, FAST, GridFAST, ORB)."""

from .common import Keypoints  # noqa: F401
from .registry import create_descriptor, create_detector, detect_and_describe  # noqa: F401
