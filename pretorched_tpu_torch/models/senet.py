"""SENet family: senet154, se_resnet50/101/152, se_resnext50/101_32x4d.

Counterpart of ``pretorched_tpu/models/senet.py`` (reference:
pretorched/models/senet.py), in NCHW with the hosted checkpoints' key
names (``layer0.conv1``, ``layer1.0.se_module.fc1``, ``last_linear``):

* the stem: three 3x3 convs (``senet154``, ``input_3x3``) or one 7x7, then
  a 3x3 / 2 max pool in ceil mode (caffe, senet.py:279-282);
* the bottlenecks: ``'se'`` (senet154: 2x and 4x wide, grouped 3x3, stride
  on the 3x3), ``'se_resnet'`` (stride on the first 1x1, caffe) and
  ``'se_resnext'`` (grouped 3x3 of ``floor(planes * 4 / 64) * groups``
  channels); the projection shortcut is a 1x1 in ``layer1`` and a
  ``downsample_kernel_size`` conv after it;
* squeeze-excite before each residual add: a global mean (in f32, as the
  JAX module takes it), 1x1 conv, ReLU, 1x1 conv, sigmoid, channel scale.
  It runs as plain PyTorch ops: the JAX package has no kernel for it;
* the head: a fixed 7x7 average pool at stride 1 (so 224 px inputs), the
  optional dropout (``senet154``: 0.2), ``last_linear``.

Every conv and the head start from the JAX package's init
(``layers.torch_conv_init``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import batch_norm, conv2d, linear

_URLS = {
    'senet154': 'http://pretorched-x.csail.mit.edu/models/senet154-c7b49a05.pth',
    'se_resnet50': 'http://pretorched-x.csail.mit.edu/models/se_resnet50-8049f9c4.pth',
    'se_resnet101': 'http://pretorched-x.csail.mit.edu/models/se_resnet101-af4def2b.pth',
    'se_resnet152': 'http://pretorched-x.csail.mit.edu/models/se_resnet152-457c373d.pth',
    'se_resnext50_32x4d': 'http://pretorched-x.csail.mit.edu/models/se_resnext50_32x4d-377ad789.pth',
    'se_resnext101_32x4d': 'http://pretorched-x.csail.mit.edu/models/se_resnext101_32x4d-bcc25309.pth',
}

pretrained_settings = {
    name: {'imagenet': image_settings(url)} for name, url in _URLS.items()
}

BLOCKS = ('se', 'se_resnet', 'se_resnext')


class SEModule(nn.Module):
    """Squeeze-excite (senet.py:85-105): ``x * sigmoid(fc2(relu(fc1(mean
    x))))``."""

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.fc1 = conv2d(channels, channels // reduction, 1, bias=True)
        self.fc2 = conv2d(channels // reduction, channels, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class Bottleneck(nn.Module):
    def __init__(self, block: str, inplanes: int, planes: int, groups: int,
                 reduction: int, stride: int, downsample: bool,
                 down_kernel: int, down_padding: int, se_identity: bool,
                 base_width: int = 4):
        super().__init__()
        if block == 'se':                 # senet154 (senet.py:134-156)
            w1, w2, g, s1, s2 = planes * 2, planes * 4, groups, 1, stride
        elif block == 'se_resnet':        # caffe: the stride on conv1
            w1, w2, g, s1, s2 = planes, planes, 1, stride, 1
        else:                             # se_resnext (and ResNeXt's)
            w1 = w2 = math.floor(planes * (base_width / 64)) * groups
            g, s1, s2 = groups, 1, stride
        self.conv1 = conv2d(inplanes, w1, 1, stride=s1)
        self.bn1 = batch_norm(w1)
        self.conv2 = conv2d(w1, w2, 3, stride=s2, padding=1, groups=g)
        self.bn2 = batch_norm(w2)
        self.conv3 = conv2d(w2, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        # se_identity: the JAX ablation that bypasses every SE gate
        self.se_module = (nn.Identity() if se_identity
                          else SEModule(planes * 4, reduction))
        self.downsample = (nn.Sequential(
            conv2d(inplanes, planes * 4, down_kernel, stride=stride,
                   padding=down_padding),
            batch_norm(planes * 4)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.se_module(self.bn3(self.conv3(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Stem(nn.Module):
    """``layer0``: the conv stem and the ceil-mode max pool."""

    def __init__(self, inplanes: int, input_3x3: bool):
        super().__init__()
        if input_3x3:
            widths = ((3, 64, 2), (64, 64, 1), (64, inplanes, 1))
            for i, (cin, cout, stride) in enumerate(widths, start=1):
                setattr(self, f'conv{i}', conv2d(cin, cout, 3, stride=stride,
                                                 padding=1))
                setattr(self, f'bn{i}', batch_norm(cout))
            self.depth = 3
        else:
            self.conv1 = conv2d(3, inplanes, 7, stride=2, padding=3)
            self.bn1 = batch_norm(inplanes)
            self.depth = 1

    def forward(self, x):
        for i in range(1, self.depth + 1):
            x = F.relu(getattr(self, f'bn{i}')(getattr(self, f'conv{i}')(x)))
        return max_pool(x, 3, 2, 0, ceil_mode=True)


class SENet(PretrainedModel):
    """Every field of the JAX ``SENet``."""

    def __init__(self, block: str, layers: Sequence[int], groups: int,
                 reduction: int = 16, dropout_p: float = 0.0,
                 inplanes: int = 128, input_3x3: bool = True,
                 downsample_kernel_size: int = 3,
                 downsample_padding: int = 1, num_classes: int = 1000,
                 se_identity: bool = False):
        if block not in BLOCKS:
            raise ValueError(f'block must be one of {BLOCKS}, got {block!r}')
        super().__init__(num_classes, 512 * 4)
        self.block = block
        self.layers = tuple(layers)
        self.layer0 = Stem(inplanes, input_3x3)
        cin = inplanes
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), start=1):
            mods = []
            # layer1's projection is a 1x1 (senet.py:307-318)
            k, p = ((downsample_kernel_size, downsample_padding)
                    if stage > 1 else (1, 0))
            for i in range(blocks):
                s = stride if i == 0 else 1
                mods.append(Bottleneck(block, cin, planes, groups, reduction,
                                       s, s != 1 or cin != planes * 4, k, p,
                                       se_identity))
                cin = planes * 4
            setattr(self, f'layer{stage}', nn.Sequential(*mods))
        self.dropout = nn.Dropout(dropout_p) if dropout_p else None
        self.last_linear = linear(self.num_features, num_classes)

    def _features(self, x):
        x = self.layer0(x)
        for stage in range(1, 5):
            x = getattr(self, f'layer{stage}')(x)
        return x

    def _logits(self, features):
        x = avg_pool(features, 7, 1)
        if self.dropout is not None:
            x = self.dropout(x)
        return self.last_linear(x.flatten(1))


CONFIGS = {
    'senet154': dict(block='se', layers=(3, 8, 36, 3), groups=64,
                     dropout_p=0.2),
    'se_resnet50': dict(block='se_resnet', layers=(3, 4, 6, 3), groups=1,
                        inplanes=64, input_3x3=False,
                        downsample_kernel_size=1, downsample_padding=0),
    'se_resnet101': dict(block='se_resnet', layers=(3, 4, 23, 3), groups=1,
                         inplanes=64, input_3x3=False,
                         downsample_kernel_size=1, downsample_padding=0),
    'se_resnet152': dict(block='se_resnet', layers=(3, 8, 36, 3), groups=1,
                         inplanes=64, input_3x3=False,
                         downsample_kernel_size=1, downsample_padding=0),
    'se_resnext50_32x4d': dict(block='se_resnext', layers=(3, 4, 6, 3),
                               groups=32, inplanes=64, input_3x3=False,
                               downsample_kernel_size=1,
                               downsample_padding=0),
    'se_resnext101_32x4d': dict(block='se_resnext', layers=(3, 4, 23, 3),
                                groups=32, inplanes=64, input_3x3=False,
                                downsample_kernel_size=1,
                                downsample_padding=0),
}


def _factory(name):
    def fn(num_classes: int = 1000, pretrained: str = 'imagenet'):
        from ..core.factory import build_model
        model = SENet(num_classes=num_classes, **CONFIGS[name])
        return build_model(name, model, pretrained_settings, num_classes,
                           pretrained)
    fn.__name__ = name
    fn.__doc__ = f'{name} (squeeze-and-excitation network).'
    return register_model(fn, name=name)


senet154 = _factory('senet154')
se_resnet50 = _factory('se_resnet50')
se_resnet101 = _factory('se_resnet101')
se_resnet152 = _factory('se_resnet152')
se_resnext50_32x4d = _factory('se_resnext50_32x4d')
se_resnext101_32x4d = _factory('se_resnext101_32x4d')

register_settings(pretrained_settings)
