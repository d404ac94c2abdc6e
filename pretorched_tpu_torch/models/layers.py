"""Leaf layers and the seeded init rules of the port.

Counterpart of ``pretorched_tpu/models/layers.py``. Layers are plain
``torch.nn`` modules in channels-first layout; what this file adds is the
init rules, applied from an explicit ``torch.Generator`` so that a factory
build is reproducible from its seed:

* ``kaiming_normal_out``: normal with std ``sqrt(2 / fan_out)`` (the JAX
  package's ``variance_scaling(2.0, 'fan_out', 'normal')``, layers.py:43),
  used by the ResNet convs (resnet3D.py:195-201);
* ``torch_conv_init``: the JAX package's conv and dense init,
  ``variance_scaling(1/3, 'fan_in', 'uniform')`` (layers.py:39-43, 111),
  which is uniform in ``+-1/sqrt(fan_in)``, with a zero bias as flax's;
  used by the layers ``conv2d`` and ``linear`` make (the 2D ResNet);
* everything else gets torch's own default: weight and bias uniform in
  ``+-1/sqrt(fan_in)`` for convs and linears, BN scale 1 and shift 0.

``BatchNorm`` is the port's batch norm: torch's, except that its train-mode
update of ``running_var`` uses the biased batch variance, as flax does.

``SpaceToDepthConv`` is not ported: it is a re-indexing of the stem for the
TPU's matrix unit, and cuDNN takes the plain strided conv.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn

_CONV_TYPES = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
# per thread: the recompute runs on the autograd engine's thread
_bn_state = threading.local()


@contextlib.contextmanager
def frozen_bn_stats():
    """Within (on this thread): train-mode ``BatchNorm`` normalizes with the
    batch statistics but leaves its running statistics alone.
    ``torch.utils.checkpoint``'s recompute runs under this, so a
    rematerialized block updates them once, in its forward, as flax's
    ``nn.remat`` does."""
    depth = getattr(_bn_state, 'frozen', 0)
    _bn_state.frozen = depth + 1
    try:
        yield
    finally:
        _bn_state.frozen = depth


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Batch norm over dim 1 of an (N, C, ...) input, with the state-dict
    keys and eval behaviour of ``nn.BatchNorm1d/2d/3d``. In train mode the
    running variance moves toward the BIASED batch variance, as flax's
    ``nn.BatchNorm`` (``pretorched_tpu/models/layers.py:91-108``) and not as
    torch's, which uses the unbiased one (they differ by n / (n - 1))."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'expected an (N, C, ...) input, got {x.dim()}D')

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        # one pass: the output and the batch mean and 1 / sqrt(var + eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if not getattr(_bn_state, 'frozen', 0):
            with torch.no_grad():
                dt = self.running_var.dtype
                var = invstd.to(dt).pow(-2) - self.eps
                self.running_mean.lerp_(mean.to(dt), self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return y


def batch_norm(channels: int, eps: float = 1e-5, momentum: float = 0.1):
    return BatchNorm(channels, eps=eps, momentum=momentum)


class Identity(nn.Module):
    """No-op module, for the ``last_linear = Identity()`` feature-extraction
    trick (reference: models/utils.py:81-87, voc2007_extract.py:147)."""

    def forward(self, x):
        return x


def conv3d_kaiming_out(in_ch, out_ch, kernel_size, stride=1, padding=0):
    """Bias-free Conv3d that ``init_parameters`` fills kaiming-normal fan_out."""
    conv = nn.Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding, bias=False)
    conv.kaiming_normal_out = True
    return conv


def conv2d(in_ch, out_ch, kernel_size, stride=1, padding=0, bias=False):
    """Conv2d that ``init_parameters`` fills with ``torch_conv_init``."""
    conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding, bias=bias)
    conv.jax_init = True
    return conv


def linear(in_features, out_features):
    """Linear that ``init_parameters`` fills with ``torch_conv_init``."""
    layer = nn.Linear(in_features, out_features)
    layer.jax_init = True
    return layer


def _fans(weight):
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def kaiming_normal_out(weight, generator):
    _, fan_out = _fans(weight)
    weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def _uniform_fan_in(weight, generator) -> float:
    """Fill ``weight`` uniform in +-1/sqrt(fan_in); returns the bound."""
    fan_in, _ = _fans(weight)
    bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.0
    weight.uniform_(-bound, bound, generator=generator)
    return bound


def torch_conv_init(weight, bias, generator):
    """The JAX package's ``torch_conv_init``: ``variance_scaling(1/3,
    'fan_in', 'uniform')``, i.e. uniform in +-sqrt(3 * (1/3) / fan_in); the
    bias is zero, as flax's ``nn.Conv`` and ``nn.Dense`` start it."""
    _uniform_fan_in(weight, generator)
    if bias is not None:
        bias.zero_()


def torch_default_init(weight, bias, generator):
    """torch's ``reset_parameters`` for conv/linear: kaiming_uniform(a=sqrt(5))
    is uniform in +-1/sqrt(fan_in), and so is the bias."""
    bound = _uniform_fan_in(weight, generator)
    if bias is not None:
        bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every parameter of ``module`` from ``generator``, in
    module registration order. A layer tagged ``zero_init`` starts at zero
    scale: the non-local block's output BN (or its output conv when it has
    no BN), so that a fresh block is the identity (nonlocalnet.py:115-124)."""
    for m in module.modules():
        if isinstance(m, _CONV_TYPES) and getattr(m, 'zero_init', False):
            m.weight.zero_()
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _CONV_TYPES) and getattr(m, 'kaiming_normal_out',
                                                    False):
            kaiming_normal_out(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _CONV_TYPES + (nn.Linear,)):
            init = (torch_conv_init if getattr(m, 'jax_init', False)
                    else torch_default_init)
            init(m.weight, m.bias, generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
            m.weight.fill_(0.0 if getattr(m, 'zero_init', False) else 1.0)
            m.bias.zero_()
