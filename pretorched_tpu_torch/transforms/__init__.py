"""Preprocessing: the PIL oracle (``utils``) and the device path (``fused``)."""
from .fused import (fused_preprocess, fused_train_apply,  # noqa: F401
                    fused_train_preprocess, preprocess_clip, ten_crop)
from .utils import (Compose, Identity, LoadImage, LoadTransformImage,  # noqa: F401
                    ToRange255, ToSpaceBGR, TransformImage)
