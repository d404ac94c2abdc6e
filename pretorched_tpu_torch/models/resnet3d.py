"""Video (3D) ResNet family — the backbone of the video slices.

Counterpart of ``pretorched_tpu/models/resnet3d.py`` (reference:
pretorched/models/resnet3D.py, with resnext3D.py, wideresnet3D.py,
pre_act_resnet3D.py and r2plus1d.py, which parameterize the same skeleton),
in native NCTHW layout. One class covers the five variants:

* stem: 7x7x7 conv, stride (1,2,2), pad 3 -> BN -> ReLU -> 3x3x3/2 pad 1
  max pool; ``s2d_stem`` evaluates it through the exact space-to-depth
  fold (``layers.SpaceToDepthConv``, the same ``conv1.weight``);
* basic and bottleneck blocks; shortcut 'A' (strided identity + zero
  channel padding, no parameters, resnet3D.py:65-74) and 'B' (1x1 conv + BN,
  keys ``downsample.0/1``);
* ResNeXt3D (``cardinality``): grouped 3x3x3, expansion 2, stage widths
  128..1024 (resnext3D.py:76-121); WideResNet3D: widths x k, expansion 2
  (wideresnet3D.py:71-106);
* PreAct (``preact``): BN -> ReLU -> conv ordering, no ReLU after the add;
* R(2+1)D (``factored``): the stem, the bottleneck's convs and the
  downsample convs are spatial (1, k, k) + temporal (k, 1, 1) pairs
  (``FactoredConv3d``, keys ``spatial_conv``, ``bn``, ``temporal_conv``);
  the basic block's 3x3x3 convs stay plain (r2plus1d.py:93-95);
* head: global average pool over (T, H, W) + ``last_linear`` (the hosted
  checkpoints call it ``fc``);
* ``remat``: ``True`` or a tuple of stages (0 = layer1 .. 3 = layer4) whose
  residual blocks are checkpointed (``torch.utils.checkpoint``) when a
  gradient is taken: backprop keeps only each block's input and recomputes
  its inside, as the JAX module's ``nn.remat`` does (resnet3d.py:210-233);
* ``stage_slice``: ``forward(x, stage_slice=(lo, hi))`` runs pipeline
  segments lo..hi-1 only (resnet3d.py:237-284); ``split_stage_variables``
  and ``pipeline_stage_fns`` give the four segments' states and functions
  for ``parallel.pipeline`` (resnet3d.py:292-317).

``resneti3d50`` is the ResNet3D-50 that loads a 2D ``resnet50`` checkpoint,
each 2D kernel broadcast over time (``zoo/convert.inflate_kernel``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import global_avg_pool, max_pool
from .layers import (SpaceToDepthConv, batch_norm, conv3d_kaiming_out,
                     frozen_bn_stats)

_KINETICS = 'kinetics-400'

model_urls = {
    _KINETICS: {
        'resnet3d18': 'http://pretorched-x.csail.mit.edu/models/resnet3d18_kinetics-e9f44270.pth',
        'resnet3d34': 'http://pretorched-x.csail.mit.edu/models/resnet3d34_kinetics-7fed38dd.pth',
        'resnet3d50': 'http://pretorched-x.csail.mit.edu/models/resnet3d50_kinetics-aad059c9.pth',
        'resnet3d101': 'http://pretorched-x.csail.mit.edu/models/resnet3d101_kinetics-8d4c9d63.pth',
        'resnet3d152': 'http://pretorched-x.csail.mit.edu/models/resnet3d152_kinetics-575c47e2.pth',
        'resnext3d101': 'http://pretorched-x.csail.mit.edu/models/resnext3d101_kinetics-8e57b772.pth',
        'wideresnet3d50': 'http://pretorched-x.csail.mit.edu/models/wideresnet3d50_kinetics-52e415d3.pth',
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


def _bn(ch):
    return batch_norm(ch)


def _tup3(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


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


class FactoredConv3d(nn.Module):
    """R(2+1)D's factored conv (r2plus1d.py:29-88): a (1, kh, kw) spatial
    conv, BN, ReLU, then a (kt, 1, 1) temporal conv, with the paper's
    intermediate width ``floor(kt kh kw in out / (kh kw in + kt out))``.
    ``s2d`` folds the spatial conv (``SpaceToDepthConv``): only a
    stride-(1, 2, 2) conv with padding k // 2, the stem, takes it."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 s2d=False):
        super().__init__()
        kt, kh, kw = _tup3(kernel)
        st, sh, sw = _tup3(stride)
        pt, ph, pw = _tup3(padding)
        mid = int(math.floor((kt * kh * kw * in_ch * out_ch)
                             / (kh * kw * in_ch + kt * out_ch)))
        if s2d:
            if (sh, sw) != (2, 2) or (ph, pw) != (kh // 2, kw // 2) \
                    or kh != kw:
                raise ValueError(f'no space-to-depth fold for kernel '
                                 f'{kernel}, stride {stride}, padding '
                                 f'{padding}')
            self.spatial_conv = SpaceToDepthConv(in_ch, mid, (1, kh, kw))
        else:
            self.spatial_conv = conv3d_kaiming_out(
                in_ch, mid, (1, kh, kw), (1, sh, sw), (0, ph, pw))
        self.bn = _bn(mid)
        self.temporal_conv = conv3d_kaiming_out(mid, out_ch, (kt, 1, 1),
                                                (st, 1, 1), (pt, 0, 0))

    def forward(self, x):
        return self.temporal_conv(F.relu(self.bn(self.spatial_conv(x))))


def _conv_maker(factored):
    """The convs of a block: plain 3D convs, or R(2+1)D's factored ones
    where ``factored``, except the basic block's 3x3x3 convs (``plain``).
    A factored conv takes no groups, as the JAX module's does not."""
    def conv(in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
             plain=False):
        if factored and not plain:
            return FactoredConv3d(in_ch, out_ch, kernel, stride, padding)
        return conv3d_kaiming_out(in_ch, out_ch, kernel, stride, padding,
                                  groups)
    return conv


class _Block(nn.Module):
    def _init_shortcut(self, inplanes, out_ch, stride, down, shortcut_type,
                       conv):
        self.stride = stride
        self.out_ch = out_ch
        self.shortcut_a = down and shortcut_type == 'A'
        if down and shortcut_type == 'B':
            self.downsample = nn.Sequential(
                conv(inplanes, out_ch, 1, stride=stride), _bn(out_ch))
        else:
            self.downsample = None

    def _shortcut(self, x):
        if self.shortcut_a:
            return _shortcut_a(x, self.out_ch, self.stride)
        if self.downsample is not None:
            return self.downsample(x)
        return x


class BasicBlock(_Block):
    """conv -> BN -> ReLU -> conv -> BN, + shortcut -> ReLU. With
    ``preact``: BN -> ReLU -> conv twice, + the shortcut of the raw input,
    no ReLU after the add (pre_act_resnet3D.py)."""

    def __init__(self, inplanes, planes, stride, down, shortcut_type,
                 conv=conv3d_kaiming_out, preact=False):
        super().__init__()
        self.preact = preact
        self.conv1 = conv(inplanes, planes, 3, stride, 1, plain=True)
        self.bn1 = _bn(inplanes if preact else planes)
        self.conv2 = conv(planes, planes, 3, 1, 1, plain=True)
        self.bn2 = _bn(planes)
        self._init_shortcut(inplanes, planes, stride, down, shortcut_type,
                            conv)

    def forward(self, x):
        if self.preact:
            out = self.conv1(F.relu(self.bn1(x)))
            out = self.conv2(F.relu(self.bn2(out)))
            return out + self._shortcut(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self._shortcut(x))


class Bottleneck(_Block):
    """1x1x1 -> 3x3x3 -> 1x1x1 to ``planes * expansion`` channels; with
    ``cardinality`` the 3x3x3 is grouped and ``cardinality * (planes //
    32)`` wide (resnext3D.py); ``preact`` as in ``BasicBlock``."""

    def __init__(self, inplanes, planes, stride, down, shortcut_type,
                 conv=conv3d_kaiming_out, preact=False, expansion=4,
                 cardinality=0):
        super().__init__()
        self.preact = preact
        out_ch = planes * expansion
        mid, groups = ((cardinality * (planes // 32), cardinality)
                       if cardinality else (planes, 1))
        self.conv1 = conv(inplanes, mid, 1)
        self.bn1 = _bn(inplanes if preact else mid)
        self.conv2 = conv(mid, mid, 3, stride, 1, groups=groups)
        self.bn2 = _bn(mid)
        self.conv3 = conv(mid, out_ch, 1)
        self.bn3 = _bn(mid if preact else out_ch)
        self._init_shortcut(inplanes, out_ch, stride, down, shortcut_type,
                            conv)

    def forward(self, x):
        if self.preact:
            out = self.conv1(F.relu(self.bn1(x)))
            out = self.conv2(F.relu(self.bn2(out)))
            out = self.conv3(F.relu(self.bn3(out)))
            return out + self._shortcut(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self._shortcut(x))


class VideoResNet(PretrainedModel):
    """NCTHW 3D ResNet: stem, four stages ``layer1..layer4``, pooled head.

    ``expansion`` defaults to the block's (1 basic, 4 bottleneck);
    ``width_per_stage`` are the planes of layer1..layer4."""

    def __init__(self, block: str, layers, num_classes: int = 400,
                 shortcut_type: str = 'B', expansion: Optional[int] = None,
                 width_per_stage: Sequence[int] = (64, 128, 256, 512),
                 cardinality: int = 0, preact: bool = False,
                 factored: bool = False, s2d_stem: bool = False,
                 remat=False):
        if block not in ('basic', 'bottleneck'):
            raise ValueError(f'unknown block {block!r}')
        if shortcut_type not in ('A', 'B'):
            raise ValueError(f'unknown shortcut_type {shortcut_type!r}')
        if expansion is None:
            expansion = 1 if block == 'basic' else 4
        super().__init__(num_classes, width_per_stage[-1] * expansion)
        self.block = block
        self.layers = tuple(layers)
        self.expansion = expansion
        self.shortcut_type = shortcut_type
        self.remat = remat
        conv = self._conv_maker(factored)
        self.conv1 = self._stem(factored, s2d_stem)
        self.bn1 = _bn(64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip(width_per_stage, layers, (1, 2, 2, 2)), start=1):
            mods = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                down = s != 1 or inplanes != planes * expansion
                if block == 'basic':
                    mods.append(BasicBlock(inplanes, planes, s, down,
                                           shortcut_type, conv, preact))
                else:
                    mods.append(Bottleneck(inplanes, planes, s, down,
                                           shortcut_type, conv, preact,
                                           expansion, cardinality))
                inplanes = planes * expansion
            setattr(self, f'layer{stage}', nn.Sequential(*mods))

    def _conv_maker(self, factored):
        """The block convs' constructor (``MVResNet`` swaps the kind)."""
        return _conv_maker(factored)

    def _stem(self, factored, s2d_stem):
        """The 7x7x7 stem conv at stride (1, 2, 2), padding 3."""
        if factored:        # a factored stem folds only its spatial half
            return FactoredConv3d(3, 64, 7, (1, 2, 2), 3, s2d=s2d_stem)
        if s2d_stem:
            return SpaceToDepthConv(3, 64, 7)
        return conv3d_kaiming_out(3, 64, 7, stride=(1, 2, 2), padding=3)

    def _after_block(self, x, stage: int, i: int):
        """Hook between residual blocks (non-local blocks go here)."""
        return x

    def _remat_stages(self):
        """0-based stages whose residual blocks are checkpointed."""
        if self.remat is True:
            return (0, 1, 2, 3)
        return tuple(self.remat or ())

    def _features(self, x, lo: int = 0, hi: int = 4):
        """Segments lo..hi-1 of [stem + layer1, layer2, layer3, layer4]."""
        if lo == 0:
            x = self._stem_pool(F.relu(self.bn1(self.conv1(x))))
        remat = self._remat_stages() if torch.is_grad_enabled() else ()
        for stage in range(lo + 1, hi + 1):
            for i, blk in enumerate(getattr(self, f'layer{stage}')):
                x = checkpointed(blk, x) if stage - 1 in remat else blk(x)
                x = self._after_block(x, stage, i)
        return x

    def _stem_pool(self, x):
        """The stem's 3x3x3 max pool at stride 2, padding 1."""
        return max_pool(x, 3, 2, 1)

    def _logits(self, features):
        return self.last_linear(global_avg_pool(features))

    def forward(self, x, stage_slice=None):
        """The logits; with ``stage_slice=(lo, hi)`` only pipeline segments
        lo..hi-1 of [stem + layer1, layer2, layer3, layer4 + pool + head]
        (the input of segment lo in, the output of segment hi-1 out).
        Composing the four slices is the whole forward: the same modules in
        the same order."""
        if stage_slice is None:
            return super().forward(x)
        lo, hi = stage_slice
        if not 0 <= lo < hi <= 4:
            raise ValueError(f'stage_slice {stage_slice}: need 0 <= lo < hi '
                             '<= 4')
        with self._autocast(x):
            x = self._features(x, lo, hi)
            return self._logits(x) if hi == 4 else x


TORCH_RENAMES = {'last_linear': 'fc'}

# the top-level parameter names of each ``stage_slice`` segment
PIPELINE_STAGE_PREFIXES = (('conv1', 'bn1', 'layer1'), ('layer2',),
                           ('layer3',), ('layer4', 'last_linear'))


def split_stage_variables(state):
    """Partition a ``VideoResNet`` state (``state_dict()``, or any mapping
    of parameter and buffer names) into the four pipeline stages' dicts by
    top-level name, for ``parallel.pipeline.pipeline_apply_stages``. A
    ``NonLocalResNet3D``'s blocks (``layer2.*``, ``layer3.*``) fall in
    stages 1 and 2."""
    stage_of = {top: i for i, prefixes in enumerate(PIPELINE_STAGE_PREFIXES)
                for top in prefixes}
    out = [{} for _ in PIPELINE_STAGE_PREFIXES]
    for key, value in state.items():
        out[stage_of[key.split('.')[0]]][key] = value
    return out


def pipeline_stage_fns(model):
    """The four ``(stage_state, x) -> y`` callables matching
    ``split_stage_variables``: each runs one ``stage_slice`` of ``model``
    with that stage's tensors (``torch.func.functional_call``); composed in
    order they equal the whole forward."""
    def make(i):
        def fn(stage_state, x):
            return torch.func.functional_call(
                model, stage_state, (x,), {'stage_slice': (i, i + 1)})
        return fn
    return [make(i) for i in range(len(PIPELINE_STAGE_PREFIXES))]

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


@register_model
def resneti3d50(num_classes: int = 339, pretrained: str = 'moments'):
    """ResNet3D-50 bootstrapped from 2D ``resnet50`` weights, each 2D kernel
    broadcast over time (reference: resnet3D.py:311-318 +
    torchvision_models.py:170-191); the 2D ``resnet50`` settings."""
    from ..core.factory import build_model
    from .resnet import pretrained_settings as resnet2d_settings
    model = VideoResNet('bottleneck', (3, 4, 6, 3), num_classes=num_classes)
    settings_map = {'resneti3d50': resnet2d_settings['resnet50']}
    return build_model('resneti3d50', model, settings_map, num_classes,
                       pretrained, torch_renames=TORCH_RENAMES, video=True)


register_settings(pretrained_settings)
