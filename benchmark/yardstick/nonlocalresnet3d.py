"""The products of one clip through the non-local I3D ResNet, from the
configuration's sizes (see ``reference/nonlocalresnet3d.py`` for the
architecture)."""

from __future__ import annotations

from .count import Attention, Conv, Linear, out_size


def products(cfg):
    arch, clip = cfg['architecture'], cfg['clip']
    stem = arch['stem']
    size = (clip['frames'], clip['crop'], clip['crop'])
    size = out_size(size, stem['kernel'], stem['stride'], stem['padding'])
    ops = [Conv(3, stem['channels'], tuple(stem['kernel']), size, False)]
    size = out_size(size, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    cin = stem['channels']
    for stage, (planes, blocks, nl) in enumerate(
            zip(arch['widths'], arch['layers'], arch['nonlocal_layers']),
            start=1):
        every = blocks // nl if nl else 0
        cout = planes * arch['expansion']
        for i in range(blocks):
            stride = 2 if stage > 1 and i == 0 else 1
            ops.append(Conv(cin, planes, (1, 1, 1), size))
            size = out_size(size, (3, 3, 3), (stride,) * 3, (1, 1, 1))
            ops += [Conv(planes, planes, (3, 3, 3), size),
                    Conv(planes, cout, (1, 1, 1), size)]
            cin = cout
            if every and i % every == 0:
                inter = int(cout * arch['nonlocal_inter'])
                n = size[0] * size[1] * size[2]
                ops += [Conv(cout, inter, (1, 1, 1), size)] * 3
                ops += [Attention(n, n, inter, inter),
                        Conv(inter, cout, (1, 1, 1), size)]
    ops.append(Linear(cin, arch['num_classes']))
    return ops


def attention_shapes(cfg):
    """(N, Nk, C, Cv) of each non-local attention of one clip."""
    return [tuple(op) for op in products(cfg) if isinstance(op, Attention)]
