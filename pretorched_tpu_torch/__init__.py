"""pretorched_tpu_torch — the PyTorch and CUDA port of ``pretorched_tpu``.

The JAX package stays the reference; this package imports no JAX. It covers
the 3D ResNet, non-local ResNet and SlowFast families, their
hosted-checkpoint loading, device-side preprocessing, multi-clip evaluation
and training, with the JAX package's Pallas kernels as hand-written CUDA
kernels for Hopper: the non-local attention forward and backward, and
SlowFast's fused eval bottleneck tail.

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
