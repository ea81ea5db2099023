from . import pcd, g2o_io, tum, images  # noqa: F401
