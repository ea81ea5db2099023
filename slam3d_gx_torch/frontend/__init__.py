from .state import FrameFeatures, Keyframe, MultiPnPResult  # noqa: F401
from .graphic_end import GraphicEnd  # noqa: F401
