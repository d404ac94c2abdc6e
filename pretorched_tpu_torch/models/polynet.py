"""PolyNet.

Counterpart of ``pretorched_tpu/models/polynet.py`` (reference:
pretorched/models/polynet.py), in NCHW with the hosted file's keys:
Inception-ResNet blocks composed into 2-way modules (two blocks on the
same input, summed into the residual) and poly-3 modules (three
sequential applications of one block whose convs are shared, each
application with its own BNs: ``PolyConv2d``, polynet.py:41-65). The
residual scales fall linearly from 1 to 0.7 over the net. Head: a 9x9
average pool (so 331 px), dropout 0.2, ``last_linear`` (2048). BN eps is
torch's 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import BasicConv2d, Concat, batch_norm, conv2d, conv_seq, linear

pretrained_settings = {
    'polynet': {
        'imagenet': image_settings(
            'http://data.lip6.fr/cadene/pretrainedmodels/polynet-f71d82a5.pth',
            input_size=(3, 331, 331)),
    }
}

_A_SCALES = (1, 0.992308, 0.984615, 0.976923, 0.969231, 0.961538, 0.953846,
             0.946154, 0.938462, 0.930769)
_B_SCALES = (0.923077, 0.915385, 0.907692, 0.9, 0.892308, 0.884615, 0.876923,
             0.869231, 0.861538, 0.853846, 0.846154, 0.838462, 0.830769,
             0.823077, 0.815385, 0.807692, 0.8, 0.792308, 0.784615, 0.776923)
_C_SCALES = (0.769231, 0.761538, 0.753846, 0.746154, 0.738462, 0.730769,
             0.723077, 0.715385, 0.707692, 0.7)


def _bc(cin, cout, kernel, stride=1, padding=0, relu=True):
    return BasicConv2d(cin, cout, kernel, stride, padding, eps=1e-5,
                       relu=relu)


def _seq(cin, specs):
    return conv_seq(cin, specs, eps=1e-5)


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _seq(3, [(32, 3, 2, 0), (32, 3, 1, 0), (64, 3, 1, 1)])
        self.conv1_branch = _bc(64, 96, 3, stride=2)
        self.conv2_short = _seq(160, [(64, 1, 1, 0), (96, 3, 1, 0)])
        self.conv2_long = _seq(160, [(64, 1, 1, 0), (64, (7, 1), 1, (3, 0)),
                                     (64, (1, 7), 1, (0, 3)), (96, 3, 1, 0)])
        self.conv2_branch = _bc(192, 192, 3, stride=2)

    def forward(self, x):
        x = self.conv1(x)
        x = torch.cat([max_pool(x, 3, 2), self.conv1_branch(x)], dim=1)
        x = torch.cat([self.conv2_short(x), self.conv2_long(x)], dim=1)
        return torch.cat([max_pool(x, 3, 2), self.conv2_branch(x)], dim=1)


class _Block(Concat):
    """Inception-ResNet block: its paths concatenated, then ``conv2d`` (a
    1x1 ``BasicConv2d`` without ReLU)."""

    def __init__(self, paths, width, cout):
        super().__init__(*paths, prefix='path')
        self.conv2d = _bc(width, cout, 1, relu=False)

    def forward(self, x):
        return self.conv2d(super().forward(x))


def block_a():
    return _Block([_seq(384, [(32, 1, 1, 0), (48, 3, 1, 1), (64, 3, 1, 1)]),
                   _seq(384, [(32, 1, 1, 0), (32, 3, 1, 1)]),
                   _bc(384, 32, 1)], 128, 384)


def block_b():
    return _Block([_seq(1152, [(128, 1, 1, 0), (160, (1, 7), 1, (0, 3)),
                               (192, (7, 1), 1, (3, 0))]),
                   _bc(1152, 192, 1)], 384, 1152)


def block_c():
    return _Block([_seq(2048, [(192, 1, 1, 0), (224, (1, 3), 1, (0, 1)),
                               (256, (3, 1), 1, (1, 0))]),
                   _bc(2048, 192, 1)], 448, 2048)


class MultiWay(nn.Module):
    """``relu(x + scale * sum(block(x)))`` over its ``blocks``."""

    def __init__(self, make_block, scale, num_blocks=2):
        super().__init__()
        self.blocks = nn.ModuleList([make_block() for _ in range(num_blocks)])
        self.scale = scale

    def forward(self, x):
        out = x
        for block in self.blocks:
            out = out + block(x) * self.scale
        return F.relu(out)


class PolyConv2d(nn.Module):
    """One bias-free conv shared by the applications of a poly module,
    with a BN (``bn_blocks.{i}``) and a ReLU for each."""

    def __init__(self, cin, cout, kernel, padding=0, num_blocks=3):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel, padding=padding)
        self.bn_blocks = nn.ModuleList([batch_norm(cout)
                                        for _ in range(num_blocks)])

    def forward(self, x, index):
        return F.relu(self.bn_blocks[index](self.conv(x)))


class PolyModule(nn.Module):
    """Poly-3: three sequential applications of one block. Each adds
    ``scale`` times its output to the residual, and its ReLU'd output is
    the next one's input (JAX ``PolyNet._poly``)."""

    def __init__(self, cin, path0, path1_ch, cout, scale, num_blocks=3):
        super().__init__()
        self.path0_names = []
        ch = cin
        for name, width, kernel, padding in path0:
            setattr(self, name, PolyConv2d(ch, width, kernel, padding,
                                           num_blocks))
            self.path0_names.append(name)
            ch = width
        self.path1 = PolyConv2d(cin, path1_ch, 1, num_blocks=num_blocks)
        self.conv2d_blocks = nn.ModuleList([
            _bc(ch + path1_ch, cout, 1, relu=False)
            for _ in range(num_blocks)])
        self.scale = scale

    def forward(self, x):
        out = x
        for i, conv2d_block in enumerate(self.conv2d_blocks):
            h = x
            for name in self.path0_names:
                h = getattr(self, name)(h, i)
            block = conv2d_block(torch.cat([h, self.path1(x, i)], dim=1))
            out = out + block * self.scale
            x = F.relu(block)
        return F.relu(out)


def poly_b(scale):
    return PolyModule(1152, [('path0_1x1', 128, 1, 0),
                             ('path0_1x7', 160, (1, 7), (0, 3)),
                             ('path0_7x1', 192, (7, 1), (3, 0))], 192, 1152,
                      scale)


def poly_c(scale):
    return PolyModule(2048, [('path0_1x1', 192, 1, 0),
                             ('path0_1x3', 224, (1, 3), (0, 1)),
                             ('path0_3x1', 256, (3, 1), (1, 0))], 192, 2048,
                      scale)


class PolyNet(PretrainedModel):
    """Every field of the JAX ``PolyNet``."""

    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 2048)
        self.stem = Stem()
        self.stage_a = nn.Sequential(*[MultiWay(block_a, s)
                                       for s in _A_SCALES])
        self.reduction_a = Concat(
            _seq(384, [(256, 1, 1, 0), (256, 3, 1, 1), (384, 3, 2, 0)]),
            _bc(384, 384, 3, stride=2), prefix='path', pool=True)
        self.stage_b = nn.Sequential(*[
            poly_b(s) if i % 2 == 0 else MultiWay(block_b, s)
            for i, s in enumerate(_B_SCALES)])
        self.reduction_b = Concat(
            _seq(1152, [(256, 1, 1, 0), (256, 3, 1, 1), (256, 3, 2, 0)]),
            _seq(1152, [(256, 1, 1, 0), (256, 3, 2, 0)]),
            _seq(1152, [(256, 1, 1, 0), (384, 3, 2, 0)]), prefix='path',
            pool=True)
        self.stage_c = nn.Sequential(*[
            poly_c(s) if i % 2 == 0 else MultiWay(block_c, s)
            for i, s in enumerate(_C_SCALES)])
        self.dropout = nn.Dropout(0.2)
        self.last_linear = linear(2048, num_classes)

    def _features(self, x):
        x = self.reduction_a(self.stage_a(self.stem(x)))
        return self.stage_c(self.reduction_b(self.stage_b(x)))

    def _logits(self, features):
        x = self.dropout(avg_pool(features, 9, 1)).flatten(1)
        return self.last_linear(x)


@register_model
def polynet(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """PolyNet (arXiv:1611.05725); eval resize 378 -> 331 center crop."""
    from ..core.factory import build_model
    return build_model('polynet', PolyNet(num_classes), pretrained_settings,
                       num_classes, pretrained)


register_settings(pretrained_settings)
