"""SlowFast networks.

Counterpart of ``pretorched_tpu/models/slowfast.py`` (reference:
pretorched/models/slowfast.py), in native NCTHW layout. Two pathways over
the same clip: Fast (temporal stride 2, 8-channel stem, temporal (3,1,1)
'head' convs everywhere) feeds Slow (stride 16, 64-channel stem,
spatial-only convs until res4) through four lateral convs, kernel (5,1,1),
stride (8,1,1), 2x channels, concatenated into the slow stream; the head
concatenates the pooled [slow, fast] features -> dropout -> ``last_linear``,
bias-free in mode 'sf'. Modes: 'sf' (both), 's' (SlowOnly), 'f' (FastOnly).
No hosted weights exist.

Reference quirks kept as they are: res3's stride is 2 only for bottleneck
blocks; a basic block's conv2 has a bias and carries the stride only when
``head_conv == 3``; slow res2's input includes the first lateral (64 + 16
= 80 channels, so its block 0 has a projection shortcut).

``fused_blocks=N`` (eval only): every stride-1 bottleneck with planes <= N
runs its tail (conv2 -> bn2 -> relu -> conv3 -> bn3 -> + residual -> relu)
through ``ops/fused_block.fused_tail_with_layout``: the CUDA kernel K2 on
the card, the plain version on the CPU. The block folds its BN and lays the
weights out for the kernel once, and keeps them until a parameter or buffer
of conv2, bn2, conv3, bn3 or the downsample changes (its version, storage,
device or dtype) or ``train()`` is called.

``s2d_stem`` evaluates both stems through the exact space-to-depth fold
(``layers.SpaceToDepthConv``, the same ``conv1.weight``): the fast stem
(5, 7, 7), O = 8, on fold 4 when H and W are multiples of 4 (else fold 2),
its BN, ReLU and pool on the natural layout; the slow stem (1, 7, 7) on
fold 2 (slowfast.py:155-205).

Module names follow the JAX package's flat names (``fast.res2.0.conv1``,
``fast.lateral_p1``, ``slow.res2.0.downsample.1``), so
``zoo.convert.state_dict_from_flax`` loads strict.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import register_model
from ..core.wrapper import PretrainedModel
from ..ops.fused_block import TailLayout, fold_bn, fused_tail_with_layout
from ..ops.pooling import global_avg_pool, max_pool
from ..utils.profiling import span
from .layers import SpaceToDepthConv, batch_norm


def _conv(cin, cout, kernel, stride=1, padding=0, bias=False):
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=bias)


def _folded(bn):
    return torch.stack(fold_bn(bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, bn.eps))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, down, head_conv):
        super().__init__()
        if head_conv == 1:
            self.conv1 = _conv(inplanes, planes, (1, 3, 3),
                               (1, stride, stride), (0, 1, 1))
        else:
            self.conv1 = _conv(inplanes, planes, (3, 1, 1), padding=(1, 0, 0))
        self.bn1 = batch_norm(planes)
        s2 = (1, stride, stride) if head_conv == 3 else 1
        self.conv2 = _conv(planes, planes, (1, 3, 3), s2, (0, 1, 1),
                           bias=True)
        self.bn2 = batch_norm(planes)
        self.downsample = _downsample(inplanes, planes, stride) if down \
            else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride, down, head_conv):
        super().__init__()
        self.planes, self.stride = planes, stride
        self.fuse = False            # set by SlowFast.fused_blocks
        if head_conv == 1:
            self.conv1 = _conv(inplanes, planes, 1)
        else:
            self.conv1 = _conv(inplanes, planes, (3, 1, 1), padding=(1, 0, 0))
        self.bn1 = batch_norm(planes)
        self.conv2 = _conv(planes, planes, (1, 3, 3), (1, stride, stride),
                           (0, 1, 1))
        self.bn2 = batch_norm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride) if down \
            else None
        self._tail_cache = None      # (source key, TailLayout)

    def tail_weights(self):
        """(w2, a2, w3, a3, wp, ap) of ``fused_bottleneck_tail``, with each
        BN folded from its module now."""
        wp = ap = None
        if self.downsample is not None:
            wp = self.downsample[0].weight.flatten(1)
            ap = _folded(self.downsample[1])
        return (self.conv2.weight, _folded(self.bn2),
                self.conv3.weight.flatten(1), _folded(self.bn3), wp, ap)

    def _tail_sources(self):
        mods = [self.conv2, self.bn2, self.conv3, self.bn3]
        if self.downsample is not None:
            mods += list(self.downsample)
        return [t for m in mods for t in (*m.parameters(recurse=False),
                                          *m.buffers(recurse=False))]

    def tail_layout(self) -> TailLayout:
        """The folded tail weights, kept with their kernel layout until a
        source tensor changes. Tensors made under ``inference_mode`` keep
        no version counter, so a block holding one folds at every call, and
        so does a trace (``torch.export``), whose tensors have no storage:
        the fold then becomes part of the traced program."""
        if torch.compiler.is_compiling():
            return TailLayout(*self.tail_weights())
        sources = self._tail_sources()
        with torch.no_grad():
            if any(t.is_inference() for t in sources):
                return TailLayout(*self.tail_weights())
            key = tuple((t._version, t.data_ptr(), t.device, t.dtype)
                        for t in sources)
            if self._tail_cache is None or self._tail_cache[0] != key:
                self._tail_cache = (key, TailLayout(*self.tail_weights()))
        return self._tail_cache[1]

    def train(self, mode: bool = True):
        self._tail_cache = None
        return super().train(mode)

    def tail(self, y1, x):
        """conv2 -> bn2 -> relu -> conv3 -> bn3 -> + residual -> relu, one
        module at a time."""
        out = F.relu(self.bn2(self.conv2(y1)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)

    def forward(self, x):
        y1 = F.relu(self.bn1(self.conv1(x)))
        if self.fuse and not self.training:
            return fused_tail_with_layout(y1, x, self.tail_layout())
        return self.tail(y1, x)


def _downsample(inplanes, out_ch, stride):
    return nn.Sequential(_conv(inplanes, out_ch, 1, (1, stride, stride)),
                         batch_norm(out_ch))


def _stage(block, inplanes, planes, blocks, stride, head_conv):
    mods = []
    for i in range(blocks):
        s = stride if i == 0 else 1
        down = s != 1 or inplanes != planes * block.expansion
        mods.append(block(inplanes, planes, s, down, head_conv))
        inplanes = planes * block.expansion
    return nn.Sequential(*mods), inplanes


def _lateral(ch):
    return _conv(ch, ch * 2, (5, 1, 1), (8, 1, 1), (2, 0, 0))


class FastPathway(nn.Module):
    def __init__(self, block, layers, laterals: bool, s2d_stem: bool = False):
        super().__init__()
        self.laterals = laterals
        self.conv1 = (SpaceToDepthConv(3, 8, (5, 7, 7), fold=4) if s2d_stem
                      else _conv(3, 8, (5, 7, 7), (1, 2, 2), (2, 3, 3)))
        self.bn1 = batch_norm(8)
        if laterals:
            self.lateral_p1 = _lateral(8)
        res3_stride = 2 if block is Bottleneck else 1
        inp = 8
        for i, (planes, stride) in enumerate(
                zip((8, 16, 32, 64), (1, res3_stride, 2, 2))):
            stage, inp = _stage(block, inp, planes, layers[i], stride, 3)
            setattr(self, f'res{i + 2}', stage)
            if laterals and i < 3:
                setattr(self, f'lateral_res{i + 2}', _lateral(inp))
        self.out_channels = inp

    def forward(self, x):
        """Pooled features and, with laterals, the four lateral outputs."""
        with span('stem'):
            x = max_pool(F.relu(self.bn1(self.conv1(x))), (1, 3, 3),
                         (1, 2, 2), (0, 1, 1))
        lat = [self.lateral_p1(x)] if self.laterals else []
        for i in range(2, 6):
            x = getattr(self, f'res{i}')(x)
            if self.laterals and i < 5:
                lat.append(getattr(self, f'lateral_res{i}')(x))
        return global_avg_pool(x), lat


class SlowPathway(nn.Module):
    def __init__(self, block, layers, lateral_channels, s2d_stem=False):
        super().__init__()
        self.conv1 = (SpaceToDepthConv(3, 64, (1, 7, 7)) if s2d_stem
                      else _conv(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3)))
        self.bn1 = batch_norm(64)
        res3_stride = 2 if block is Bottleneck else 1
        inp = 64
        for i, (planes, stride, head_conv) in enumerate(
                zip((64, 128, 256, 512), (1, res3_stride, 2, 2),
                    (1, 1, 3, 3))):
            stage, inp = _stage(block, inp + lateral_channels[i], planes,
                                layers[i], stride, head_conv)
            setattr(self, f'res{i + 2}', stage)
        self.out_channels = inp

    def forward(self, x, lateral=None):
        with span('stem'):
            x = max_pool(F.relu(self.bn1(self.conv1(x))), (1, 3, 3),
                         (1, 2, 2), (0, 1, 1))
        for i in range(2, 6):
            if lateral:
                x = torch.cat([x, lateral[i - 2]], dim=1)
            x = getattr(self, f'res{i}')(x)
        return global_avg_pool(x)


class SlowFast(PretrainedModel):
    """The two-pathway network on (N, 3, T, H, W) clips."""

    def __init__(self, block: str = 'bottleneck', layers=(3, 4, 6, 3),
                 num_classes: int = 400, mode: str = 'sf',
                 dropout_rate: float = 0.5, slow_stride: int = 16,
                 fast_stride: int = 2, s2d_stem: bool = False,
                 fused_blocks: int = 0):
        if block not in ('basic', 'bottleneck'):
            raise ValueError(f'unknown block {block!r}')
        mode = mode.lower()
        if mode not in ('sf', 's', 'f'):
            raise ValueError(f'unknown mode {mode!r}')
        blk = Bottleneck if block == 'bottleneck' else BasicBlock
        fast = slow = None
        if mode in ('sf', 'f'):
            fast = FastPathway(blk, layers, laterals=mode == 'sf',
                               s2d_stem=s2d_stem)
        if mode in ('sf', 's'):
            # the laterals' widths: 2 x the fast stem's and stages' outputs
            lat = ((16, 16 * blk.expansion, 32 * blk.expansion,
                    64 * blk.expansion) if mode == 'sf' else (0,) * 4)
            slow = SlowPathway(blk, layers, lat, s2d_stem)
        features = sum(p.out_channels for p in (slow, fast) if p is not None)
        super().__init__(num_classes, features)
        self.block, self.layers, self.mode = block, tuple(layers), mode
        self.dropout_rate = dropout_rate
        self.slow_stride, self.fast_stride = slow_stride, fast_stride
        self.s2d_stem = s2d_stem
        if fast is not None:
            self.fast = fast
        if slow is not None:
            self.slow = slow
        if mode == 'sf':
            self.last_linear = nn.Linear(features, num_classes, bias=False)
        self.fused_blocks = fused_blocks

    @property
    def fused_blocks(self) -> int:
        return self._fused_blocks

    @fused_blocks.setter
    def fused_blocks(self, n: int):
        """Fuse the tail of every stride-1 bottleneck with planes <= n in
        eval mode (the JAX package's ``_can_fuse``); 0 turns it off."""
        self._fused_blocks = n
        for m in self.modules():
            if isinstance(m, Bottleneck):
                m.fuse = bool(n and m.planes <= n and m.stride == 1)

    def _features(self, x):
        if self.mode == 'f':
            return self.fast(x[:, :, ::self.fast_stride])[0]
        if self.mode == 's':
            return self.slow(x[:, :, ::self.slow_stride])
        fast, lateral = self.fast(x[:, :, ::self.fast_stride])
        slow = self.slow(x[:, :, ::self.slow_stride], lateral)
        return torch.cat([slow, fast], dim=1)

    def _logits(self, features):
        x = F.dropout(features, self.dropout_rate, self.training)
        return self.last_linear(x)


def SlowFastV0(block: str = 'bottleneck', layers=(3, 4, 6, 3),
               num_classes: int = 10, dropout: float = 0.5, **kwargs):
    """The reference's monolithic variant (slowfast.py:399-575): for the
    bottleneck configs it is built with, the same network as
    ``SlowFast(mode='sf')``, which is returned."""
    return SlowFast(block=block, layers=layers, num_classes=num_classes,
                    mode='sf', dropout_rate=dropout, **kwargs)


_LAYERS = {
    'resnet18': ('basic', (2, 2, 2, 2)),
    'resnet50': ('bottleneck', (3, 4, 6, 3)),
    'resnet101': ('bottleneck', (3, 4, 23, 3)),
    'resnet152': ('bottleneck', (3, 8, 36, 3)),
    'resnet200': ('bottleneck', (3, 24, 36, 3)),
}


def _factory(short):
    name = f'slowfast_{short}'

    def fn(mode: str = 'SF', num_classes: int = 400, pretrained=None,
           dropout: float = 0.5, **kwargs):
        from ..core.factory import build_model
        block, layers = _LAYERS[short]
        model = SlowFast(block=block, layers=layers, num_classes=num_classes,
                         mode=mode, dropout_rate=dropout, **kwargs)
        return build_model(name, model, {name: {}}, num_classes, pretrained,
                           video=True)
    fn.__name__ = short
    fn.__doc__ = (f'SlowFast {short}: mode "sf" (two-pathway), '
                  f'"s" (SlowOnly), "f" (FastOnly).')
    return register_model(fn, name=name)


resnet18 = _factory('resnet18')
resnet50 = _factory('resnet50')
resnet101 = _factory('resnet101')
resnet152 = _factory('resnet152')
resnet200 = _factory('resnet200')
