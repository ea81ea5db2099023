from .state import FrameFeatures, Keyframe, MultiPnPResult  # noqa: F401
from .graphic_end import GraphicEnd, GraphicEnd2  # noqa: F401
