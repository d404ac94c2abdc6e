"""2D ResNet family (torchvision-compatible weights).

Counterpart of ``pretorched_tpu/models/resnet.py:47-170`` (reference:
pretorched/models/torchvision_models.py:443-530), in NCHW:

* stem: 7x7/2 pad 3 conv -> BN -> ReLU -> 3x3/2 max pool, padded 1
  (``stem_pool='pad'``) or unpadded in ceil mode (``'ceil'``, caffe);
* basic and bottleneck blocks, the bottleneck's stride on its 3x3 conv
  (``stride_on='conv2'``, torchvision) or on its first 1x1
  (``'conv1'``, caffe); projection shortcut ``downsample.0/1``;
* head: global average pool (``logits_pool='global'``) or a fixed
  7x7 average pool (``'avg7'``), then ``last_linear`` (the hosted
  checkpoints call it ``fc``).

The other fields carry the later families' variants: ``conv_bias``
(fbresnet), ``inner_width_mult`` (wideresnet: wider 3x3s), ``no_bn`` (a
BN-free net with conv biases), ``width_per_stage``. ``remat`` checkpoints
each residual block (``torch.utils.checkpoint``) when a gradient is taken.
Every conv and the head start from the JAX package's init
(``layers.torch_conv_init``). ``s2d_stem`` evaluates a bias-free stem
through the exact space-to-depth fold (``layers.SpaceToDepthConv``, the same
``conv1.weight``, started kaiming-normal as the JAX module's); a stem with
a bias stays plain (resnet.py:132-137).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, global_avg_pool, max_pool
from .layers import SpaceToDepthConv, batch_norm, conv2d, linear
from .resnet3d import checkpointed

model_urls = {
    'resnet18': 'https://download.pytorch.org/models/resnet18-5c106cde.pth',
    'resnet34': 'https://download.pytorch.org/models/resnet34-333f7ec4.pth',
    'resnet50': 'https://download.pytorch.org/models/resnet50-19c8e357.pth',
    'resnet101': 'https://download.pytorch.org/models/resnet101-5d3b4d8f.pth',
    'resnet152': 'https://download.pytorch.org/models/resnet152-b121ed2d.pth',
}

pretrained_settings = {
    name: {'imagenet': image_settings(url)} for name, url in model_urls.items()
}
# extra hosted checkpoints (reference: torchvision_models.py:58-63, 96-143)
pretrained_settings['resnet50']['moments'] = image_settings(
    'http://moments.csail.mit.edu/moments_models/resnet50_moments-fd0c4436.pth',
    num_classes=339)
pretrained_settings['resnet18']['places365'] = image_settings(
    'http://pretorched-x.csail.mit.edu/models/resnet18_places365-dbad67aa.pth',
    num_classes=365)
pretrained_settings['resnet50']['places365'] = image_settings(
    'http://pretorched-x.csail.mit.edu/models/resnet50_places365-a570fcfc.pth',
    num_classes=365)


def _bn(channels, no_bn):
    return nn.Identity() if no_bn else batch_norm(channels)


class _Block(nn.Module):
    def _init_downsample(self, inplanes, out_ch, stride, down, bias, no_bn):
        self.downsample = (nn.Sequential(
            conv2d(inplanes, out_ch, 1, stride=stride, bias=bias),
            _bn(out_ch, no_bn)) if down else None)

    def _shortcut(self, x):
        return x if self.downsample is None else self.downsample(x)


class BasicBlock(_Block):
    def __init__(self, inplanes, planes, stride, down, *, bias, no_bn):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride, 1, bias=bias)
        self.bn1 = _bn(planes, no_bn)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, bias=bias)
        self.bn2 = _bn(planes, no_bn)
        self._init_downsample(inplanes, planes, stride, down, bias, no_bn)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self._shortcut(x))


class Bottleneck(_Block):
    def __init__(self, inplanes, planes, stride, down, *, bias, no_bn,
                 stride_on, inner_width_mult):
        super().__init__()
        inner = int(planes * inner_width_mult)
        s1, s2 = (stride, 1) if stride_on == 'conv1' else (1, stride)
        self.conv1 = conv2d(inplanes, inner, 1, s1, bias=bias)
        self.bn1 = _bn(inner, no_bn)
        self.conv2 = conv2d(inner, inner, 3, s2, 1, bias=bias)
        self.bn2 = _bn(inner, no_bn)
        self.conv3 = conv2d(inner, planes * 4, 1, bias=bias)
        self.bn3 = _bn(planes * 4, no_bn)
        self._init_downsample(inplanes, planes * 4, stride, down, bias, no_bn)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self._shortcut(x))


class ResNet(PretrainedModel):
    """NCHW 2D ResNet with torchvision checkpoint naming."""

    def __init__(self, block: str, layers: Sequence[int],
                 num_classes: int = 1000,
                 width_per_stage: Sequence[int] = (64, 128, 256, 512),
                 conv_bias: bool = False, stride_on: str = 'conv2',
                 stem_pool: str = 'pad', logits_pool: str = 'global',
                 inner_width_mult: float = 1.0, no_bn: bool = False,
                 s2d_stem: bool = False, remat: bool = False):
        if block not in ('basic', 'bottleneck'):
            raise ValueError(f'unknown block {block!r}')
        for name, value, allowed in (('stride_on', stride_on,
                                      ('conv1', 'conv2')),
                                     ('stem_pool', stem_pool, ('pad', 'ceil')),
                                     ('logits_pool', logits_pool,
                                      ('global', 'avg7'))):
            if value not in allowed:
                raise ValueError(f'{name} must be one of {allowed}, '
                                 f'got {value!r}')
        self.expansion = 1 if block == 'basic' else 4
        super().__init__(num_classes, width_per_stage[-1] * self.expansion)
        self.block = block
        self.layers = tuple(layers)
        self.stem_pool = stem_pool
        self.logits_pool = logits_pool
        self.remat = remat
        if s2d_stem and not conv_bias:
            self.conv1 = SpaceToDepthConv(3, 64, 7, ndim=2)
        else:
            self.conv1 = conv2d(3, 64, 7, stride=2, padding=3, bias=conv_bias)
        self.bn1 = _bn(64, no_bn)
        block_cls = BasicBlock if block == 'basic' else Bottleneck
        # the bottleneck's variants (the JAX basic block has neither)
        extra = {} if block == 'basic' else {
            'stride_on': stride_on, 'inner_width_mult': inner_width_mult}
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip(width_per_stage, layers, (1, 2, 2, 2)), start=1):
            mods = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                down = s != 1 or inplanes != planes * self.expansion
                mods.append(block_cls(inplanes, planes, s, down,
                                      bias=conv_bias, no_bn=no_bn, **extra))
                inplanes = planes * self.expansion
            setattr(self, f'layer{stage}', nn.Sequential(*mods))
        self.last_linear = linear(self.num_features, num_classes)

    def _features(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        if self.stem_pool == 'ceil':
            x = max_pool(x, 3, 2, 0, ceil_mode=True)
        else:
            x = max_pool(x, 3, 2, 1)
        remat = self.remat and torch.is_grad_enabled()
        for stage in range(1, 5):
            for blk in getattr(self, f'layer{stage}'):
                x = checkpointed(blk, x) if remat else blk(x)
        return x

    def _logits(self, features):
        if self.logits_pool == 'avg7':
            x = avg_pool(features, 7, 7).flatten(1)
        else:
            x = global_avg_pool(features)
        return self.last_linear(x)


CONFIGS = {
    'resnet18': ('basic', (2, 2, 2, 2)),
    'resnet34': ('basic', (3, 4, 6, 3)),
    'resnet50': ('bottleneck', (3, 4, 6, 3)),
    'resnet101': ('bottleneck', (3, 4, 23, 3)),
    'resnet152': ('bottleneck', (3, 8, 36, 3)),
}

# torch state-dict key prefix renames applied by the loader
TORCH_RENAMES = {'last_linear': 'fc'}


def _factory(name):
    def fn(num_classes: int = 1000, pretrained: str = 'imagenet'):
        from ..core.factory import build_model
        block, layers = CONFIGS[name]
        model = ResNet(block, layers, num_classes=num_classes)
        return build_model(name, model, pretrained_settings, num_classes,
                           pretrained, torch_renames=TORCH_RENAMES)
    fn.__name__ = name
    fn.__doc__ = f'Constructs a {name} model (torchvision-weight compatible).'
    return register_model(fn, name=name)


resnet18 = _factory('resnet18')
resnet34 = _factory('resnet34')
resnet50 = _factory('resnet50')
resnet101 = _factory('resnet101')
resnet152 = _factory('resnet152')

register_settings(pretrained_settings)
