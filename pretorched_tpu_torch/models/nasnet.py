"""NASNet-A Large (6 @ 4032) and Mobile (4 @ 1056).

Counterpart of ``pretorched_tpu/models/nasnet.py`` (reference:
pretorched/models/nasnet.py and nasnet_mobile.py, ports of the TF models),
in NCHW with the hosted checkpoints' key names. Both sizes share one cell
grammar; what makes them TF's is the padding:

* ``max_pool_pad`` / ``avg_pool_pad``: zero-pad the top row and left
  column, pool 3x3 / 2 padded 1, drop the first row and column
  (nasnet.py:32-57);
* the 'specific' separable branches (Mobile's ``cell_stem_1`` and
  ``reduction_cell_1``) and every branch of ``reduction_cell_0``: the same
  top-left pad before the first depthwise conv and crop after it
  (nasnet_mobile.py:96-157);
* the factorized shrink of the previous state (``path_1`` / ``path_2``):
  two stride-2 1x1 convs, the second on the input shifted by one pixel
  (pad bottom-right, drop the first row and column), concatenated, BN;
* every branch's average pool ignores its padding
  (``count_include_pad=False``); BN eps is 1e-3.

Separable convs are a depthwise conv (``groups`` = channels) and a
pointwise one. The cells run as plain PyTorch ops on cuDNN: the JAX package
has no kernel for them. Large: stem 96, 331 px, an 11x11 head pool and a
1001-class checkpoint whose background row the ``imagenet`` load drops
(nasnet.py:618-625). Mobile: stem 32, 224 px, a 7x7 head pool.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import batch_norm, conv2d, linear

_L_URL = 'http://pretorched-x.csail.mit.edu/models/nasnetalarge-82673142.pth'
pretrained_settings = {
    'nasnetalarge': {
        'imagenet': image_settings(_L_URL, input_size=(3, 331, 331),
                                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
        'imagenet+background': image_settings(
            _L_URL, input_size=(3, 331, 331), mean=(0.5, 0.5, 0.5),
            std=(0.5, 0.5, 0.5), num_classes=1001),
    },
    'nasnetamobile': {
        'imagenet': image_settings(
            'http://pretorched-x.csail.mit.edu/models/nasnetamobile-5d17248c.pth',
            mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    },
}


def _pad_tl(x):
    return F.pad(x, (1, 0, 1, 0))


def _crop_tl(x):
    return x[:, :, 1:, 1:]


def max_pool_pad(x):
    return _crop_tl(max_pool(_pad_tl(x), 3, 2, 1))


def avg_pool_pad(x):
    return _crop_tl(avg_pool(_pad_tl(x), 3, 2, 1, count_include_pad=False))


def _avg31(x):
    return avg_pool(x, 3, 1, 1, count_include_pad=False)


def _max32(x):
    return max_pool(x, 3, 2, 1)


def _avg32(x):
    return avg_pool(x, 3, 2, 1, count_include_pad=False)


def _bn(channels):
    return batch_norm(channels, eps=1e-3)


class SeparableConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, padding):
        super().__init__()
        self.depthwise_conv2d = conv2d(cin, cin, kernel, stride, padding,
                                       groups=cin)
        self.pointwise_conv2d = conv2d(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv2d(self.depthwise_conv2d(x))


class BranchSeparables(nn.Module):
    """ReLU, separable conv (``cin`` -> ``mid``, strided), BN, ReLU,
    separable conv (-> ``cout``), BN. ``pad_tl``: the first separable conv
    runs on the top-left padded input and its output loses its first row
    and column (the 'specific' and reduction variants)."""

    def __init__(self, cin, cout, kernel, stride, padding, mid=None,
                 pad_tl=False):
        super().__init__()
        mid = cin if mid is None else mid
        self.pad_tl = pad_tl
        self.separable_1 = SeparableConv(cin, mid, kernel, stride, padding)
        self.bn_sep_1 = _bn(mid)
        self.separable_2 = SeparableConv(mid, cout, kernel, 1, padding)
        self.bn_sep_2 = _bn(cout)

    def forward(self, x):
        x = F.relu(x)
        if self.pad_tl:
            x = _crop_tl(self.separable_1(_pad_tl(x)))
        else:
            x = self.separable_1(x)
        x = F.relu(self.bn_sep_1(x))
        return self.bn_sep_2(self.separable_2(x))


class ReluConvBn(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = conv2d(cin, cout, 1, stride=stride)
        self.bn = _bn(cout)

    def forward(self, x):
        return self.bn(self.conv(F.relu(x)))


class _Path(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = conv2d(cin, cout, 1)


class _Cell(nn.Module):
    def _init_prev_path(self, cin, out_half):
        self.path_1 = _Path(cin, out_half)
        self.path_2 = _Path(cin, out_half)
        self.final_path_bn = _bn(2 * out_half)

    def _prev_path(self, x_prev):
        """The stride-2 dual-path shrink of the previous state
        (nasnet.py:198-207, 293-304)."""
        x = F.relu(x_prev)
        p1 = self.path_1.conv(avg_pool(x, 1, 2, count_include_pad=False))
        p2 = F.pad(x, (0, 1, 0, 1))[:, :, 1:, 1:]
        p2 = self.path_2.conv(avg_pool(p2, 1, 2, count_include_pad=False))
        return self.final_path_bn(torch.cat([p1, p2], dim=1))


class CellStem0(_Cell):
    def __init__(self, cin, filters):
        super().__init__()
        self.out_channels = 4 * filters
        self.conv_1x1 = ReluConvBn(cin, filters)
        self.comb_iter_0_left = BranchSeparables(filters, filters, 5, 2, 2)
        self.comb_iter_0_right = BranchSeparables(cin, filters, 7, 2, 3,
                                                  mid=filters)
        self.comb_iter_1_right = BranchSeparables(cin, filters, 7, 2, 3,
                                                  mid=filters)
        self.comb_iter_2_right = BranchSeparables(cin, filters, 5, 2, 2,
                                                  mid=filters)
        self.comb_iter_4_left = BranchSeparables(filters, filters, 3, 1, 1)

    def forward(self, x):
        x1 = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x1) + self.comb_iter_0_right(x)
        c1 = _max32(x1) + self.comb_iter_1_right(x)
        c2 = _avg32(x1) + self.comb_iter_2_right(x)
        c3 = _avg31(c0) + c1
        c4 = self.comb_iter_4_left(c0) + _max32(x1)
        return torch.cat([c1, c2, c3, c4], dim=1)


class CellStem1(_Cell):
    def __init__(self, cin_conv0, cin_stem0, filters, specific):
        super().__init__()
        self.out_channels = 4 * filters
        self.specific = specific
        self.conv_1x1 = ReluConvBn(cin_stem0, filters)
        self._init_prev_path(cin_conv0, filters // 2)
        right = 2 * (filters // 2)
        kw = dict(pad_tl=specific)
        self.comb_iter_0_left = BranchSeparables(filters, filters, 5, 2, 2,
                                                 **kw)
        self.comb_iter_0_right = BranchSeparables(right, filters, 7, 2, 3,
                                                  **kw)
        self.comb_iter_1_right = BranchSeparables(right, filters, 7, 2, 3,
                                                  **kw)
        self.comb_iter_2_right = BranchSeparables(right, filters, 5, 2, 2,
                                                  **kw)
        self.comb_iter_4_left = BranchSeparables(filters, filters, 3, 1, 1,
                                                 **kw)

    def forward(self, x_conv0, x_stem_0):
        left = self.conv_1x1(x_stem_0)
        right = self._prev_path(x_conv0)
        mp, ap = ((max_pool_pad, avg_pool_pad) if self.specific
                  else (_max32, _avg32))
        c0 = self.comb_iter_0_left(left) + self.comb_iter_0_right(right)
        c1 = mp(left) + self.comb_iter_1_right(right)
        c2 = ap(left) + self.comb_iter_2_right(right)
        c3 = _avg31(c0) + c1
        c4 = self.comb_iter_4_left(c0) + mp(left)
        return torch.cat([c1, c2, c3, c4], dim=1)


class NormalCell(_Cell):
    """``FirstCell`` (``first=True``: the previous state through the
    factorized shrink, ``out_left`` channels each path) or ``NormalCell``
    (a 1x1 of the previous state)."""

    def __init__(self, cin, cin_prev, out_left, out_right, first):
        super().__init__()
        self.first = first
        if first:
            self._init_prev_path(cin_prev, out_left)
            cl = 2 * out_left
        else:
            self.conv_prev_1x1 = ReluConvBn(cin_prev, out_left)
            cl = out_left
        self.out_channels = cl + 5 * out_right
        self.conv_1x1 = ReluConvBn(cin, out_right)
        self.comb_iter_0_left = BranchSeparables(out_right, out_right, 5, 1, 2)
        # the left branches keep the left width in a NormalCell, and widen
        # to out_right in a FirstCell (both add to out_right-wide terms)
        lw = out_right if first else out_left
        self.comb_iter_0_right = BranchSeparables(cl, lw, 3, 1, 1)
        self.comb_iter_1_left = BranchSeparables(cl, lw, 5, 1, 2)
        self.comb_iter_1_right = BranchSeparables(cl, lw, 3, 1, 1)
        self.comb_iter_4_left = BranchSeparables(out_right, out_right, 3, 1, 1)

    def forward(self, x, x_prev):
        left = (self._prev_path(x_prev) if self.first
                else self.conv_prev_1x1(x_prev))
        right = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(right) + self.comb_iter_0_right(left)
        c1 = self.comb_iter_1_left(left) + self.comb_iter_1_right(left)
        c2 = _avg31(right) + left
        c3 = _avg31(left) + _avg31(left)
        c4 = self.comb_iter_4_left(right) + right
        return torch.cat([left, c0, c1, c2, c3, c4], dim=1)


class ReductionCell(_Cell):
    """``ReductionCell0`` (``reduction_style``: every branch pads at the
    top left) or ``ReductionCell1`` (plain, or 'specific' in Mobile)."""

    def __init__(self, cin, cin_prev, out_left, out_right, reduction_style,
                 specific):
        super().__init__()
        self.out_channels = 4 * out_right
        self.padded = reduction_style or specific
        self.conv_prev_1x1 = ReluConvBn(cin_prev, out_left)
        self.conv_1x1 = ReluConvBn(cin, out_right)
        kw = dict(pad_tl=self.padded)
        self.comb_iter_0_left = BranchSeparables(out_right, out_right, 5, 2,
                                                 2, **kw)
        self.comb_iter_0_right = BranchSeparables(out_left, out_right, 7, 2,
                                                  3, **kw)
        self.comb_iter_1_right = BranchSeparables(out_left, out_right, 7, 2,
                                                  3, **kw)
        self.comb_iter_2_right = BranchSeparables(out_left, out_right, 5, 2,
                                                  2, **kw)
        self.comb_iter_4_left = BranchSeparables(out_right, out_right, 3, 1,
                                                 1, **kw)

    def forward(self, x, x_prev):
        left = self.conv_prev_1x1(x_prev)
        right = self.conv_1x1(x)
        mp, ap = ((max_pool_pad, avg_pool_pad) if self.padded
                  else (_max32, _avg32))
        c0 = self.comb_iter_0_left(right) + self.comb_iter_0_right(left)
        c1 = mp(right) + self.comb_iter_1_right(left)
        c2 = ap(right) + self.comb_iter_2_right(left)
        c3 = _avg31(c0) + c1
        c4 = self.comb_iter_4_left(c0) + mp(right)
        return torch.cat([c1, c2, c3, c4], dim=1)


class _ConvBn(nn.Module):
    def __init__(self, cout):
        super().__init__()
        self.conv = conv2d(3, cout, 3, stride=2)
        self.bn = _bn(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class NASNetA(PretrainedModel):
    """Every field of the JAX ``NASNetA``. ``specific_stem1`` (Mobile)
    selects the 'specific' padding of ``cell_stem_1`` and
    ``reduction_cell_1`` and feeds each stage's first cell the last normal
    cell as its previous state (Large: the one before it)."""

    def __init__(self, num_classes: int = 1000, stem_filters: int = 96,
                 penultimate_filters: int = 4032, filters_multiplier: int = 2,
                 num_normal_cells: int = 6, specific_stem1: bool = False,
                 head_pool: int = 11):
        mult = filters_multiplier
        filters = penultimate_filters // 24
        stem0 = CellStem0(stem_filters, filters // mult ** 2)
        stem1 = CellStem1(stem_filters, stem0.out_channels, filters // mult,
                          specific_stem1)
        cells, prev, cur = [], stem0.out_channels, stem1.out_channels
        for stage in range(3):
            f = filters * mult ** stage
            ci = stage * 6     # torch numbering: cells 0-5, 6-11, 12-17
            for j in range(num_normal_cells):
                cell = NormalCell(cur, prev, f // 2 if j == 0 else f, f,
                                  first=j == 0)
                cells.append((f'cell_{ci + j}', cell))
                prev, cur = cur, cell.out_channels
            if stage < 2:
                red = ReductionCell(cur, prev, f * mult, f * mult,
                                    reduction_style=stage == 0,
                                    specific=specific_stem1)
                cells.append((f'reduction_cell_{stage}', red))
                prev = cur if specific_stem1 else prev
                cur = red.out_channels
        super().__init__(num_classes, cur)
        self.specific_stem1 = specific_stem1
        self.head_pool = head_pool
        self.conv0 = _ConvBn(stem_filters)
        self.cell_stem_0 = stem0
        self.cell_stem_1 = stem1
        self.cell_names = [name for name, _ in cells]
        for name, cell in cells:
            setattr(self, name, cell)
        self.dropout = nn.Dropout(0.5)
        self.last_linear = linear(cur, num_classes)

    def _features(self, x):
        x_conv0 = self.conv0(x)
        x_stem_0 = self.cell_stem_0(x_conv0)
        prev, cur = x_stem_0, self.cell_stem_1(x_conv0, x_stem_0)
        for name in self.cell_names:
            nxt = getattr(self, name)(cur, prev)
            if name.startswith('reduction') and not self.specific_stem1:
                # Large feeds the next first cell the second-to-last
                # normal cell (nasnet.py cell_6(x_red0, x_cell_4))
                cur = nxt
            else:
                prev, cur = cur, nxt
        return cur

    def _logits(self, features):
        x = avg_pool(F.relu(features), self.head_pool, 1).flatten(1)
        return self.last_linear(self.dropout(x))


@register_model
def nasnetalarge(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """NASNet-A-Large (arXiv:1707.07012), 331x331."""
    from ..core.factory import build_model
    model = NASNetA(num_classes=num_classes, stem_filters=96,
                    penultimate_filters=4032, num_normal_cells=6,
                    specific_stem1=False, head_pool=11)
    # the hosted checkpoint has 1001 classes: 'imagenet' drops the
    # background row (nasnet.py:618-625)
    background = ('last_linear',) if pretrained == 'imagenet' else ()
    return build_model('nasnetalarge', model, pretrained_settings,
                       num_classes, pretrained,
                       background_class_keys=background)


@register_model
def nasnetamobile(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """NASNet-A-Mobile (4 @ 1056), 224x224."""
    from ..core.factory import build_model
    model = NASNetA(num_classes=num_classes, stem_filters=32,
                    penultimate_filters=1056, num_normal_cells=4,
                    specific_stem1=True, head_pool=7)
    return build_model('nasnetamobile', model, pretrained_settings,
                       num_classes, pretrained)


register_settings(pretrained_settings)
