"""pretorched_tpu_torch — the PyTorch and CUDA port of ``pretorched_tpu``.

The JAX package stays the reference; this package imports no JAX. It covers
every factory of the JAX package (the 2D zoo, the 3D ResNet family, the
non-local ResNet, SlowFast, TRN, DenseNet3D, MultiView ResNet, SoundNet and
BigGAN), their hosted-checkpoint loading, WAV ingestion, VOC2007 transfer,
host and device-side preprocessing, the image-folder loader, image and
multi-clip evaluation (shape buckets for native-length clips), training and
online serving (``serving.py``), with the JAX package's Pallas kernels as
hand-written CUDA kernels for Hopper: the non-local attention forward and
backward, and SlowFast's fused eval bottleneck tail.

Public contract (the reference's, pretorched/__init__.py:11-83):

    import pretorched_tpu_torch as pretorched
    model = pretorched.__dict__['nonlocalresnet3d50'](num_classes=400,
                                                      pretrained='kinetics-400')
    model.eval().bfloat16().cuda()
    logits = model(x)            # x: (B, 3, T, H, W)
    f = model.features(x); y = model.logits(f)
    pretorched.model_names, pretorched.pretrained_settings
"""

from . import models  # noqa: F401  (registers the factories and settings)
from .core.registry import MODEL_REGISTRY, model_names, pretrained_settings  # noqa: F401
from .core.wrapper import PretrainedModel  # noqa: F401
from .models.layers import Identity  # noqa: F401

# Flat factory namespace: pretorched_tpu_torch.__dict__[name](num_classes, pretrained=...)
globals().update(MODEL_REGISTRY)

__all__ = ['models', 'model_names', 'pretrained_settings', 'PretrainedModel',
           'Identity'] + sorted(MODEL_REGISTRY)
