"""Decoding and dataset helpers."""

from .utils import (AveragePrecisionMeter, Warp, download_url,  # noqa: F401
                    load_imagenet_classes)
from .voc import (Voc2007Classification, download_voc2007,  # noqa: F401
                  object_categories)
from .audio import load_audio, resample, soundnet_input  # noqa: F401
