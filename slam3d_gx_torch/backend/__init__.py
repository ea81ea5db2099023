from .pose_graph import PoseGraphOptimizer, SLAMEnd  # noqa: F401
