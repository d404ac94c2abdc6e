"""Preprocessing: the PIL oracle (``utils``) and the device path (``fused``)."""
from .fused import fused_preprocess, preprocess_clip  # noqa: F401
from .utils import (Compose, Identity, LoadImage, LoadTransformImage,  # noqa: F401
                    ToRange255, ToSpaceBGR, TransformImage)
