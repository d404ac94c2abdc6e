"""PNASNet-5-Large (TF port).

Counterpart of ``pretorched_tpu/models/pnasnet.py`` (reference:
pretorched/models/pnasnet.py), in NCHW with the hosted file's keys. One
cell grammar (CellBase.cell_forward, pnasnet.py:151-178) over two stem
cells and 12 cells, on NASNet-A's pieces (``models/nasnet.py``): the
separable branches (``BranchSeparables``, BN eps 1e-3), the top-left pad
and crop of TF's SAME padding (``zero_pad``, at ``cell_4`` only), the
factorized reduction of the previous state, ``ReluConvBn``. The cells walk
``(prev, cur)`` with a config per cell (pnasnet.py:163-178). Head: ReLU,
an 11x11 average pool (so 331 px), dropout 0.5, ``last_linear`` (4320).
The hosted file has 1001 classes: an ``imagenet`` load drops the
background row (pnasnet.py:384-391).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import conv2d, linear
from .nasnet import (BranchSeparables, ReluConvBn, _bn, _Cell, _ConvBn,
                     max_pool_pad)

_URL = 'http://data.lip6.fr/cadene/pretrainedmodels/pnasnet5large-bf079911.pth'
pretrained_settings = {
    'pnasnet5large': {
        'imagenet': image_settings(_URL, input_size=(3, 331, 331),
                                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
        'imagenet+background': image_settings(
            _URL, input_size=(3, 331, 331), mean=(0.5, 0.5, 0.5),
            std=(0.5, 0.5, 0.5), num_classes=1001),
    }
}


def _max_pool(x, stride, zero_pad=False):
    if zero_pad:        # stride 2 only (cell_4)
        return max_pool_pad(x)
    return max_pool(x, 3, stride, 1)


def _sep(cin, cout, kernel, stride=1, zero_pad=False, mid=None):
    return BranchSeparables(cin, cout, kernel, stride, kernel // 2, mid=mid,
                            pad_tl=zero_pad)


class FactorizedReduction(_Cell):
    """NASNet's stride-2 dual-path shrink (``path_1``, ``path_2``,
    ``final_path_bn``) as a module of its own."""

    def __init__(self, cin, cout):
        super().__init__()
        self._init_prev_path(cin, cout // 2)

    def forward(self, x):
        return self._prev_path(x)


class MaxPoolConvBn(nn.Module):
    """3x3/2 max pool padded 1, 1x1 conv, BN (stem 0's
    ``comb_iter_0_right``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = conv2d(cin, cout, 1)
        self.bn = _bn(cout)

    def forward(self, x):
        return self.bn(self.conv(_max_pool(x, 2)))


class CellStem0(nn.Module):
    def __init__(self, cin, out):
        super().__init__()
        self.conv_1x1 = ReluConvBn(cin, out)
        self.comb_iter_0_left = _sep(cin, out, 5, 2, mid=out)
        self.comb_iter_0_right = MaxPoolConvBn(cin, out)
        self.comb_iter_1_left = _sep(out, out, 7, 2)
        self.comb_iter_2_left = _sep(out, out, 5, 2)
        self.comb_iter_2_right = _sep(out, out, 3, 2)
        self.comb_iter_3_left = _sep(out, out, 3)
        self.comb_iter_4_left = _sep(cin, out, 3, 2, mid=out)
        self.comb_iter_4_right = ReluConvBn(out, out, stride=2)

    def forward(self, x):
        right = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x) + self.comb_iter_0_right(x)
        c1 = self.comb_iter_1_left(right) + _max_pool(right, 2)
        c2 = self.comb_iter_2_left(right) + self.comb_iter_2_right(right)
        c3 = self.comb_iter_3_left(c2) + _max_pool(right, 2)
        c4 = self.comb_iter_4_left(x) + self.comb_iter_4_right(right)
        return torch.cat([c0, c1, c2, c3, c4], dim=1)


class Cell(nn.Module):
    """A PNASNet cell on the previous state (``left``) and the current one
    (``right``). ``match_prev``: the previous state has twice the current
    one's size and goes through the factorized reduction."""

    def __init__(self, cin_left, cin_right, out, is_reduction=False,
                 zero_pad=False, match_prev=False):
        super().__init__()
        stride = 2 if is_reduction else 1
        self.stride, self.zero_pad = stride, zero_pad
        self.is_reduction = is_reduction
        self.out_channels = 5 * out
        self.conv_prev_1x1 = (FactorizedReduction(cin_left, out) if match_prev
                              else ReluConvBn(cin_left, out))
        self.conv_1x1 = ReluConvBn(cin_right, out)
        kw = dict(stride=stride, zero_pad=zero_pad)
        self.comb_iter_0_left = _sep(out, out, 5, **kw)
        self.comb_iter_1_left = _sep(out, out, 7, **kw)
        self.comb_iter_2_left = _sep(out, out, 5, **kw)
        self.comb_iter_2_right = _sep(out, out, 3, **kw)
        self.comb_iter_3_left = _sep(out, out, 3)
        self.comb_iter_4_left = _sep(out, out, 3, **kw)
        if is_reduction:
            self.comb_iter_4_right = ReluConvBn(out, out, stride=2)

    def forward(self, x_left, x_right):
        left = self.conv_prev_1x1(x_left)
        right = self.conv_1x1(x_right)
        s, z = self.stride, self.zero_pad
        c0 = self.comb_iter_0_left(left) + _max_pool(left, s, z)
        c1 = self.comb_iter_1_left(right) + _max_pool(right, s, z)
        c2 = self.comb_iter_2_left(right) + self.comb_iter_2_right(right)
        c3 = self.comb_iter_3_left(c2) + _max_pool(right, s, z)
        c4 = self.comb_iter_4_left(left) + (
            self.comb_iter_4_right(right) if self.is_reduction else right)
        return torch.cat([c0, c1, c2, c3, c4], dim=1)


# the cells after the stems (pnasnet.py:302-336): width, and the reduction,
# zero-pad and factorized-reduction flags
_CELLS = ((216, False, False, True), (216, False, False, False),
          (216, False, False, False), (216, False, False, False),
          (432, True, True, False), (432, False, False, True),
          (432, False, False, False), (432, False, False, False),
          (864, True, False, False), (864, False, False, True),
          (864, False, False, False), (864, False, False, False))


class PNASNet5Large(PretrainedModel):
    """Every field of the JAX ``PNASNet5Large``."""

    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 4320)
        self.conv_0 = _ConvBn(96)
        self.cell_stem_0 = CellStem0(96, 54)
        self.cell_stem_1 = Cell(96, 270, 108, is_reduction=True,
                                match_prev=True)
        prev, cur = 270, 540
        for i, (out, red, zero_pad, match_prev) in enumerate(_CELLS):
            cell = Cell(prev, cur, out, red, zero_pad, match_prev)
            setattr(self, f'cell_{i}', cell)
            prev, cur = cur, cell.out_channels
        self.dropout = nn.Dropout(0.5)
        self.last_linear = linear(4320, num_classes)

    def _features(self, x):
        x_conv0 = self.conv_0(x)
        x_stem_0 = self.cell_stem_0(x_conv0)
        prev, cur = x_stem_0, self.cell_stem_1(x_conv0, x_stem_0)
        for i in range(len(_CELLS)):
            prev, cur = cur, getattr(self, f'cell_{i}')(prev, cur)
        return cur

    def _logits(self, features):
        x = avg_pool(F.relu(features), 11, 1).flatten(1)
        return self.last_linear(self.dropout(x))


@register_model
def pnasnet5large(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """PNASNet-5-Large (arXiv:1712.00559), 331x331."""
    from ..core.factory import build_model
    background = ('last_linear',) if pretrained == 'imagenet' else ()
    return build_model('pnasnet5large', PNASNet5Large(num_classes),
                       pretrained_settings, num_classes, pretrained,
                       background_class_keys=background)


register_settings(pretrained_settings)
