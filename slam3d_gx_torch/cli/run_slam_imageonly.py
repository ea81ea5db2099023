"""run_SLAM_imageonly [loops]: the image-only SLAM entry point on the card
(reference src/run_SLAM_imageonly.cpp). The same run loop as run_SLAM with the
GraphicEnd2 frontend: no point clouds, no planes."""

from __future__ import annotations

from ..frontend import GraphicEnd2
from .run_slam import run


def main(argv=None, device=None, stats=None) -> int:
    return run(GraphicEnd2, argv, device=device, stats=stats)


if __name__ == "__main__":
    raise SystemExit(main())
