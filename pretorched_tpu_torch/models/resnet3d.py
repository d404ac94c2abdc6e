"""Video (3D) ResNet — the backbone of the video slice.

Counterpart of ``pretorched_tpu/models/resnet3d.py:82-281`` (reference:
pretorched/models/resnet3D.py), in native NCTHW layout:

* stem: 7x7x7 conv, stride (1,2,2), pad 3 -> BN -> ReLU -> 3x3x3/2 pad 1
  max pool;
* basic and bottleneck blocks; shortcut 'A' (strided identity + zero
  channel padding, no parameters, resnet3D.py:65-74) and 'B' (1x1 conv + BN,
  keys ``downsample.0/1``);
* head: global average pool over (T, H, W) + ``last_linear`` (the hosted
  checkpoints call it ``fc``);
* ``remat``: ``True`` or a tuple of stages (0 = layer1 .. 3 = layer4) whose
  residual blocks are checkpointed (``torch.utils.checkpoint``) when a
  gradient is taken: backprop keeps only each block's input and recomputes
  its inside, as the JAX module's ``nn.remat`` does (resnet3d.py:210-233).

The JAX module's ``cardinality``, ``preact``, ``factored`` and ``s2d_stem``
variants are not ported yet; asking for one raises.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import global_avg_pool, max_pool
from .layers import batch_norm, conv3d_kaiming_out, frozen_bn_stats

_KINETICS = 'kinetics-400'

model_urls = {
    _KINETICS: {
        'resnet3d18': 'http://pretorched-x.csail.mit.edu/models/resnet3d18_kinetics-e9f44270.pth',
        'resnet3d34': 'http://pretorched-x.csail.mit.edu/models/resnet3d34_kinetics-7fed38dd.pth',
        'resnet3d50': 'http://pretorched-x.csail.mit.edu/models/resnet3d50_kinetics-aad059c9.pth',
        'resnet3d101': 'http://pretorched-x.csail.mit.edu/models/resnet3d101_kinetics-8d4c9d63.pth',
        'resnet3d152': 'http://pretorched-x.csail.mit.edu/models/resnet3d152_kinetics-575c47e2.pth',
    },
    'moments': {
        'resnet3d50': 'http://pretorched-x.csail.mit.edu/models/resnet3d50_16seg_moments-6eb53860.pth',
    },
}

DATASET_CLASSES = {_KINETICS: 400, 'moments': 339}


def video_settings(names, urls=model_urls):
    """Per-model {dataset: settings} in the reference's schema
    (resnet3D.py:33-55)."""
    out = {}
    for name in names:
        out[name] = {}
        for dataset, n in DATASET_CLASSES.items():
            out[name][dataset] = image_settings(
                urls.get(dataset, {}).get(name), num_classes=n)
    return out


pretrained_settings = video_settings([
    'resnet3d10', 'resnet3d18', 'resnet3d34', 'resnet3d50', 'resnet3d101',
    'resnet3d152', 'resnet3d200'])


WIDTHS = (64, 128, 256, 512)     # planes of layer1..layer4


def _bn(ch):
    return batch_norm(ch)


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward; the
    recompute leaves BN running statistics alone (``frozen_bn_stats``)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_bn_stats()))


def _shortcut_a(x, out_ch, stride):
    """avg_pool3d(kernel=1, stride) == strided subsample, then zero-pad the
    new channels (resnet3D.py:65-74)."""
    out = x[:, :, ::stride, ::stride, ::stride]
    pad = out_ch - out.shape[1]
    if pad > 0:
        out = F.pad(out, (0, 0, 0, 0, 0, 0, 0, pad))
    return out


class _Block(nn.Module):
    def _init_shortcut(self, inplanes, out_ch, stride, down, shortcut_type):
        self.stride = stride
        self.out_ch = out_ch
        self.shortcut_a = down and shortcut_type == 'A'
        if down and shortcut_type == 'B':
            self.downsample = nn.Sequential(
                conv3d_kaiming_out(inplanes, out_ch, 1, stride=stride),
                _bn(out_ch))
        else:
            self.downsample = None

    def _shortcut(self, x):
        if self.shortcut_a:
            return _shortcut_a(x, self.out_ch, self.stride)
        if self.downsample is not None:
            return self.downsample(x)
        return x


class BasicBlock(_Block):
    def __init__(self, inplanes, planes, stride, down, shortcut_type):
        super().__init__()
        self.conv1 = conv3d_kaiming_out(inplanes, planes, 3, stride, 1)
        self.bn1 = _bn(planes)
        self.conv2 = conv3d_kaiming_out(planes, planes, 3, 1, 1)
        self.bn2 = _bn(planes)
        self._init_shortcut(inplanes, planes, stride, down, shortcut_type)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self._shortcut(x))


class Bottleneck(_Block):
    def __init__(self, inplanes, planes, stride, down, shortcut_type):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = conv3d_kaiming_out(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = conv3d_kaiming_out(planes, planes, 3, stride, 1)
        self.bn2 = _bn(planes)
        self.conv3 = conv3d_kaiming_out(planes, out_ch, 1)
        self.bn3 = _bn(out_ch)
        self._init_shortcut(inplanes, out_ch, stride, down, shortcut_type)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self._shortcut(x))


class VideoResNet(PretrainedModel):
    """NCTHW 3D ResNet: stem, four stages ``layer1..layer4``, pooled head."""

    def __init__(self, block: str, layers, num_classes: int = 400,
                 shortcut_type: str = 'B', cardinality: int = 0,
                 preact: bool = False, factored: bool = False,
                 s2d_stem: bool = False, remat=False):
        unported = {'cardinality': cardinality, 'preact': preact,
                    'factored': factored, 's2d_stem': s2d_stem}
        asked = sorted(k for k, v in unported.items() if v)
        if asked:
            raise NotImplementedError(
                f'VideoResNet variants not ported yet: {asked}')
        if block not in ('basic', 'bottleneck'):
            raise ValueError(f'unknown block {block!r}')
        if shortcut_type not in ('A', 'B'):
            raise ValueError(f'unknown shortcut_type {shortcut_type!r}')
        self.expansion = 1 if block == 'basic' else 4
        super().__init__(num_classes, WIDTHS[-1] * self.expansion)
        self.block = block
        self.layers = tuple(layers)
        self.shortcut_type = shortcut_type
        self.remat = remat
        self.conv1 = conv3d_kaiming_out(3, 64, 7, stride=(1, 2, 2), padding=3)
        self.bn1 = _bn(64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip(WIDTHS, layers, (1, 2, 2, 2)), start=1):
            mods = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                down = s != 1 or inplanes != planes * self.expansion
                if block == 'basic':
                    mods.append(BasicBlock(inplanes, planes, s, down,
                                           shortcut_type))
                else:
                    mods.append(Bottleneck(inplanes, planes, s, down,
                                           shortcut_type))
                inplanes = planes * self.expansion
            setattr(self, f'layer{stage}', nn.Sequential(*mods))

    def _after_block(self, x, stage: int, i: int):
        """Hook between residual blocks (non-local blocks go here)."""
        return x

    def _remat_stages(self):
        """0-based stages whose residual blocks are checkpointed."""
        if self.remat is True:
            return (0, 1, 2, 3)
        return tuple(self.remat or ())

    def _features(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        remat = self._remat_stages() if torch.is_grad_enabled() else ()
        for stage in range(1, 5):
            for i, blk in enumerate(getattr(self, f'layer{stage}')):
                x = checkpointed(blk, x) if stage - 1 in remat else blk(x)
                x = self._after_block(x, stage, i)
        return x

    def _logits(self, features):
        return self.last_linear(global_avg_pool(features))


TORCH_RENAMES = {'last_linear': 'fc'}

CONFIGS = {
    'resnet3d10': ('basic', (1, 1, 1, 1)),
    'resnet3d18': ('basic', (2, 2, 2, 2)),
    'resnet3d34': ('basic', (3, 4, 6, 3)),
    'resnet3d50': ('bottleneck', (3, 4, 6, 3)),
    'resnet3d101': ('bottleneck', (3, 4, 23, 3)),
    'resnet3d152': ('bottleneck', (3, 8, 36, 3)),
    'resnet3d200': ('bottleneck', (3, 24, 36, 3)),
}


def get_fine_tuning_parameter_names(ft_begin_index: int):
    """Parameter-name prefixes to fine-tune (reference: resnet3D.py:221-239):
    the stages from ``ft_begin_index`` on plus the classifier; None for 0
    (train everything)."""
    if ft_begin_index == 0:
        return None
    return [f'layer{i}' for i in range(ft_begin_index, 5)] + ['last_linear']


def _build(name, num_classes, pretrained, shortcut_type):
    from ..core.factory import build_model
    block, layers = CONFIGS[name]
    model = VideoResNet(block, layers, num_classes=num_classes,
                        shortcut_type=shortcut_type)
    return build_model(name, model, pretrained_settings, num_classes,
                       pretrained, torch_renames=TORCH_RENAMES, video=True)


def _factory(name, default_nc=400, default_pt=_KINETICS, shortcut='B'):
    def fn(num_classes: int = default_nc, pretrained: str = default_pt,
           shortcut_type: str = shortcut):
        return _build(name, num_classes, pretrained, shortcut_type)
    fn.__name__ = name
    fn.__doc__ = f'Constructs a {name} video model.'
    return register_model(fn, name=name)


resnet3d10 = _factory('resnet3d10', default_pt=None)
resnet3d18 = _factory('resnet3d18', shortcut='A')
resnet3d34 = _factory('resnet3d34', shortcut='A')
resnet3d50 = _factory('resnet3d50')
resnet3d101 = _factory('resnet3d101')
resnet3d152 = _factory('resnet3d152')
resnet3d200 = _factory('resnet3d200', default_pt=None)

register_settings(pretrained_settings)
