"""The products of one clip through SlowFast, from the configuration's
sizes (see ``reference/slowfast.py`` for the architecture), and the shapes
of the bottleneck tails that the fused tail kernel K2 takes."""

from __future__ import annotations

from .count import Conv, Linear, out_size


def _pathway(arch, frames, crop, widths, stem, temporal, lateral_in):
    """(products, tails, lateral outputs' channels) of one pathway."""
    size = out_size((frames, crop, crop), stem['kernel'], (1, 2, 2),
                    [k // 2 for k in stem['kernel']])
    ops = [Conv(3, stem['channels'], tuple(stem['kernel']), size, False)]
    size = out_size(size, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    lat = arch['lateral']
    laterals, tails = [], []
    cin = stem['channels']

    def lateral(ch):
        out = out_size(size, lat['kernel'], lat['stride'],
                       [k // 2 for k in lat['kernel']])
        ops.append(Conv(ch, 2 * ch, tuple(lat['kernel']), out))
        laterals.append(2 * ch)

    if lateral_in is None:
        lateral(cin)
    for i, (planes, blocks, stride) in enumerate(
            zip(widths, arch['layers'], arch['stage_strides'])):
        if lateral_in is not None:
            cin += lateral_in[i]
        cout = planes * arch['expansion']
        for b in range(blocks):
            s = stride if b == 0 else 1
            t = temporal[i]
            ops.append(Conv(cin, planes, (3, 1, 1) if t else (1, 1, 1), size))
            size = out_size(size, (1, 3, 3), (1, s, s), (0, 1, 1))
            ops += [Conv(planes, planes, (1, 3, 3), size),
                    Conv(planes, cout, (1, 1, 1), size)]
            proj = s != 1 or cin != cout
            if proj:
                ops.append(Conv(cin, cout, (1, 1, 1), size))
            if lateral_in is None and s == 1 and planes <= arch['fused_blocks']:
                tails.append((*size, cin, planes, cout, proj))
            cin = cout
        if lateral_in is None and i < 3:
            lateral(cin)
    return ops, tails, laterals, cin


def _both(cfg):
    arch, clip = cfg['architecture'], cfg['clip']
    frames, crop = clip['frames'], clip['crop']
    fast, tails, laterals, fast_out = _pathway(
        arch, frames // arch['fast_stride'], crop, arch['fast_widths'],
        arch['fast_stem'], [True] * 4, None)
    slow, _, _, slow_out = _pathway(
        arch, frames // arch['slow_stride'], crop, arch['slow_widths'],
        arch['slow_stem'], arch['slow_temporal'], laterals)
    head = Linear(fast_out + slow_out, arch['num_classes'])
    return fast + slow + [head], tails


def products(cfg):
    return _both(cfg)[0]


def tail_shapes(cfg):
    """(t, h, w, cin, cm, cout, projection) of each fused tail of one clip;
    K2's shape is (clips, *this)."""
    return _both(cfg)[1]
