"""Leaf layers and the seeded init rules of the port.

Counterpart of ``pretorched_tpu/models/layers.py``. Layers are plain
``torch.nn`` modules in channels-first layout; what this file adds is the
init rules, applied from an explicit ``torch.Generator`` so that a factory
build is reproducible from its seed:

* ``kaiming_normal_out``: normal with std ``sqrt(2 / fan_out)`` (the JAX
  package's ``variance_scaling(2.0, 'fan_out', 'normal')``, layers.py:43),
  used by the ResNet convs (resnet3D.py:195-201);
* everything else gets torch's own default: weight and bias uniform in
  ``+-1/sqrt(fan_in)`` for convs and linears, BN scale 1 and shift 0.

``SpaceToDepthConv`` is not ported: it is a re-indexing of the stem for the
TPU's matrix unit, and cuDNN takes the plain strided conv.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_CONV_TYPES = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_BN_TYPES = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)


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


def _fans(weight):
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def kaiming_normal_out(weight, generator):
    _, fan_out = _fans(weight)
    weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def torch_default_init(weight, bias, generator):
    """torch's ``reset_parameters`` for conv/linear: kaiming_uniform(a=sqrt(5))
    is uniform in +-1/sqrt(fan_in), and so is the bias."""
    fan_in, _ = _fans(weight)
    bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.0
    weight.uniform_(-bound, bound, generator=generator)
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
            torch_default_init(m.weight, m.bias, generator)
        elif isinstance(m, _BN_TYPES):
            m.reset_running_stats()
            m.weight.fill_(0.0 if getattr(m, 'zero_init', False) else 1.0)
            m.bias.zero_()
