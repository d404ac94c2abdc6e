"""Space-to-depth folding of spatial stride-2 stem convolutions.

Counterpart of ``pretorched_tpu/ops/space_to_depth.py``, on channels-first
tensors (``(N, C, [T,] H, W)``) and torch conv weights (``(O, C, [kt,] kh,
kw)``). A stride-2 stem over 3 channels becomes a stride-1 conv over the
2x2 (or 4x4) space-to-depth view of its input: exactly the same math, the
weights re-indexed, never changed.

Derivation (per strided dim, kernel 7 / stride 2 / pad 3):
    y[h] = sum_{i=0..6} W[i] * xpad3[2h + i]
         = sum_{j=0..7} W'[j] * xpad4[2h + j]      with W'[0]=0, W'[j]=W[j-1]
         = sum_{b=0..3} sum_{r=0,1} W'[2b+r] * u[h+b, r]
where u[m, r] = xpad4[2m + r] is the space-to-depth view (left pad 4 = the
original 3 plus one zero tap for parity, right pad 2). Any odd kernel k with
pad k//2 and stride 2 folds the same way.

Fold-4 takes a 4x4 space-to-depth of the input and computes the output in
its 2x2 parity layout (``4 O`` output channels); fold 2x4 folds H by 2 and W
by 4. The folded channels are ordered as the JAX functions order them,
``(r_h, r_w, c)`` on the input and ``(p_h, p_w, o)`` on the output, so each
function here equals its JAX twin up to ``moveaxis(1, -1)`` on activations
and the kernel transpose (OI[T]HW <-> [T]HWIO) on weights. Plain tensor
functions: pad, reshape, permute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _space_to_depth(x, cell_h, cell_w, pad_h, pad_w):
    """(N, C, *mid, H, W) -> (N, cell_h * cell_w * C, *mid, H', W') with
    H, W padded by ``pad_h``, ``pad_w`` (left, right); channel order
    (r_h, r_w, c)."""
    x = F.pad(x, (*pad_w, *pad_h))
    n, c, *mid, h, w = x.shape
    m = len(mid)
    x = x.reshape(n, c, *mid, h // cell_h, cell_h, w // cell_w, cell_w)
    x = x.permute(0, 3 + m, 5 + m, 1, *range(2, 2 + m), 2 + m, 4 + m)
    return x.reshape(n, cell_h * cell_w * c, *mid, h // cell_h, w // cell_w)


def space_to_depth_2d(x, lpad: int = 4, rpad: int = 2):
    """(N, C, ..., H, W) -> (N, 4C, ..., (H+lpad+rpad)/2, (W+lpad+rpad)/2).

    Channel order: (r_h, r_w, c)."""
    return _space_to_depth(x, 2, 2, (lpad, rpad), (lpad, rpad))


def _fold2_kernel(weight):
    """(O, C, *mid, kh, kw) stride-2 kernel -> (O, 4C, *mid, kh//2+1,
    kw//2+1) stride-1 kernel in ``space_to_depth_2d``'s channel order."""
    kh, kw = weight.shape[-2:]
    w = F.pad(weight, (1, (kw + 1) % 2, 1, (kh + 1) % 2))
    o, c, *mid, hh, ww = w.shape
    m = len(mid)
    w = w.reshape(o, c, *mid, hh // 2, 2, ww // 2, 2)
    w = w.permute(0, 3 + m, 5 + m, 1, *range(2, 2 + m), 2 + m, 4 + m)
    return w.reshape(o, 4 * c, *mid, hh // 2, ww // 2)


def fold_stem_kernel_2d(weight):
    """(O, C, kh, kw) stride-2 kernel -> (O, 4C, kh//2+1, kw//2+1) stride-1
    kernel matching ``space_to_depth_2d``'s channel order. kh, kw odd."""
    return _fold2_kernel(weight)


def fold_stem_kernel_3d(weight):
    """(O, C, kt, kh, kw) kernel with stride (1, 2, 2) -> stride-1 kernel
    (O, 4C, kt, kh//2+1, kw//2+1); the time dim untouched."""
    return _fold2_kernel(weight)


def space_to_depth_4(x):
    """(N, C, ..., H, W) -> (N, 16C, ..., (H+8)/4, (W+8)/4), pads (4, 4).

    Cell q holds x[4q + r - 4]; channel order (r_h, r_w, c). H, W % 4 == 0."""
    h, w = x.shape[-2:]
    if h % 4 or w % 4:
        raise ValueError(f'space_to_depth_4 needs H, W % 4 == 0, got {h}, {w}')
    return _space_to_depth(x, 4, 4, (4, 4), (4, 4))


def _fold4_kernel_1d(wp, cells=3):
    """(k+1 padded taps, ...) -> (cells, 4, 2, ...) per-dim fold-4 kernel.

    ``wp`` is W' (left-padded by one zero tap). K[c, r, p] = wp[4c + r - 2p]
    where the index is in range, else 0."""
    kp = wp.shape[0]
    zero = torch.zeros_like(wp[0])
    rows = [wp[j] if 0 <= j < kp else zero
            for c in range(cells) for r in range(4) for p in range(2)
            for j in (4 * c + r - 2 * p,)]
    return torch.stack(rows).reshape((cells, 4, 2) + tuple(wp.shape[1:]))


def _to_jax_layout(weight):
    """(O, C, kt, kh, kw) -> (kt, kh, kw, C, O)."""
    return weight.permute(2, 3, 4, 1, 0)


def _from_jax_layout(kernel):
    """(kt, kh, kw, C, O) -> (O, C, kt, kh, kw)."""
    return kernel.permute(4, 3, 0, 1, 2)


def fold4_stem_kernel_3d(weight):
    """(O, C, kt, 7, 7) stride-(1,2,2) kernel -> (4O, 16C, kt, 3, 3)
    stride-1 fold-4 kernel. Input channel order (r_h, r_w, c); output
    channel order (p_h, p_w, o)."""
    o, c, kt, kh, kw = weight.shape
    if kh != 7 or kw != 7:
        raise ValueError(f'fold-4 takes a 7x7 spatial kernel, got {kh}x{kw}')
    w = F.pad(_to_jax_layout(weight), (0, 0, 0, 0, 1, 0, 1, 0))
    w = w.movedim(1, 0)                        # (8h, kt, 8w, c, o)
    w = _fold4_kernel_1d(w)                    # (3ch, 4rh, 2ph, kt, 8w, c, o)
    w = w.movedim(4, 0)                        # (8w, 3ch, 4rh, 2ph, kt, c, o)
    w = _fold4_kernel_1d(w)                    # (3cw, 4rw, 2pw, 3ch, 4rh, 2ph, kt, c, o)
    # -> (kt, ch, cw, (rh, rw, c), (ph, pw, o))
    w = w.permute(6, 3, 0, 4, 1, 7, 5, 2, 8)
    return _from_jax_layout(w.reshape(kt, 3, 3, 16 * c, 4 * o))


def space_to_depth_2x4(x):
    """(N, C, ..., H, W) -> (N, 8C, ..., (H+6)/2, (W+8)/4).

    H cells of 2 (pads 4, 2: u[q, r] = x[2q + r - 4]), W cells of 4 (pads
    4, 4: u[q, r] = x[4q + r - 4]); channel order (r_h, r_w, c). Requires
    H % 2 == 0 and W % 4 == 0."""
    h, w = x.shape[-2:]
    if h % 2 or w % 4:
        raise ValueError(f'space_to_depth_2x4 needs H % 2 == 0 and W % 4 == 0,'
                         f' got {h}, {w}')
    return _space_to_depth(x, 2, 4, (4, 2), (4, 4))


def fold2x4_stem_kernel_3d(weight):
    """(O, C, kt, 7, 7) stride-(1,2,2) kernel -> (2O, 8C, kt, 4, 3)
    stride-1 mixed-fold kernel. Input channel order (r_h, r_w, c) matching
    ``space_to_depth_2x4``; output channel order (p_w, o)."""
    o, c, kt, kh, kw = weight.shape
    if kh != 7 or kw != 7:
        raise ValueError(f'fold 2x4 takes a 7x7 spatial kernel, got {kh}x{kw}')
    w = F.pad(_to_jax_layout(weight), (0, 0, 0, 0, 1, 0, 1, 0))
    w = w.movedim(1, 0)                        # (8h, kt, 8w, c, o)
    w = w.reshape((4, 2) + tuple(w.shape[1:]))  # (4ch, 2rh, kt, 8w, c, o)
    w = w.movedim(3, 0)                        # (8w, 4ch, 2rh, kt, c, o)
    w = _fold4_kernel_1d(w)                    # (3cw, 4rw, 2pw, 4ch, 2rh, kt, c, o)
    # -> (kt, ch, cw, (rh, rw, c), (pw, o))
    w = w.permute(5, 3, 0, 4, 1, 6, 2, 7)
    return _from_jax_layout(w.reshape(kt, 4, 3, 8 * c, 2 * o))


def depth_to_space_w2(y):
    """(N, 2O, T, H, Wc) W-parity-folded map, channel order (p_w, o) ->
    (N, O, T, H, 2Wc)."""
    n, c2, t, h, w = y.shape
    y = y.reshape(n, 2, c2 // 2, t, h, w).permute(0, 2, 3, 4, 5, 1)
    return y.reshape(n, c2 // 2, t, h, 2 * w)


def depth_to_space_2(y):
    """(N, 4O, T, Hc, Wc) parity-folded map, channel order (p_h, p_w, o) ->
    (N, O, T, 2Hc, 2Wc)."""
    n, c4, t, h, w = y.shape
    y = y.reshape(n, 2, 2, c4 // 4, t, h, w).permute(0, 3, 4, 5, 1, 6, 2)
    return y.reshape(n, c4 // 4, t, 2 * h, 2 * w)


def _shift_in_neg_inf(b, dim):
    """``b`` moved one step along ``dim``, the first row -inf."""
    first = torch.full_like(b.narrow(dim, 0, 1), float('-inf'))
    return torch.cat([first, b.narrow(dim, 0, b.shape[dim] - 1)], dim=dim)


def folded_max_pool_3s2(z):
    """(1,3,3) / stride (1,2,2) / pad (0,1,1) max pool on a parity-folded
    map.

    z: (N, 4C, T, Ho, Wo), channel order (p_h, p_w, c), with natural
    x[2m+p] == z[.., m] of parity p. Per dim: y[h'] = max(u[h'-1, 1],
    u[h', 0], u[h', 1]) (h'=-1 is the -inf pad), so the pool's stride 2
    aligns with the output parities and no depth-to-space is needed.
    Output: (N, C, T, Ho, Wo) in the natural layout."""
    n, c4, t, h, w = z.shape
    z = z.reshape(n, 2, 2, c4 // 4, t, h, w)
    a, b = z[:, 0], z[:, 1]                          # fold h
    m = torch.maximum(torch.maximum(a, b), _shift_in_neg_inf(b, dim=4))
    a, b = m[:, 0], m[:, 1]                          # fold w
    return torch.maximum(torch.maximum(a, b), _shift_in_neg_inf(b, dim=4))
