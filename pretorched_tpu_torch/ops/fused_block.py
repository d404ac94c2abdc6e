"""Fused eval-mode bottleneck tail: BN folding, the plain version, dispatch.

Counterpart of ``pretorched_tpu/ops/pallas/fused_block.py``. The tail of a
bottleneck block in eval mode, with every BN folded to a per-channel scale
and shift:

    y2  = relu(bn2(conv2_(1,3,3)(y1)))        stride 1, padding (0, 1, 1)
    y3  = bn3(conv3_1x1(y2))
    out = relu(y3 + residual(x))              identity or 1x1 projection + BN

The port keeps its own channels-first layout at these functions: y1
(N, Cm, T, H, W), x_res (N, Cin, T, H, W), out (N, Cout, T, H, W); weights
in torch's layouts, w2 (Cm, Cm, 3, 3) (or the conv's (Cm, Cm, 1, 3, 3)), w3
(Cout, Cm), wp (Cout, Cin); a2, a3, ap the folded BN as (2, C) rows
[scale; shift] (``fold_bn``). The JAX function takes (B, T, H, W, C) and
HWIO; its tests move the axes.

* ``fused_bottleneck_tail``: the registered operator
  ``pretorched::fused_bottleneck_tail`` (``ops/library.py``): the CUDA
  kernel K2 (``ops/cuda/fused_block.py``) for CUDA tensors, the plain
  version for CPU tensors. Eval only on both: an input that needs a
  gradient raises, as the JAX function has no backward.
* ``fused_tail_with_layout``: what ``models/slowfast.py`` calls, with the
  folded weights held in a ``TailLayout``. An eager call on the card
  launches K2 with the layout kept between calls; on the CPU and under
  ``torch.export`` it goes through the operator.
* ``fused_bottleneck_tail_reference``: the plain PyTorch version, the JAX
  reference's arithmetic (l.207-228): f32 accumulation, the affine in f32,
  y2 rounded to the input dtype before conv3, the input dtype out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda.fused_block import (TailLayout, check_tail_inputs,
                               fused_bottleneck_tail_laid_out_cuda,
                               needs_grad)


def fold_bn(weight, bias, mean, var, eps: float = 1e-5):
    """Per-channel (s, b) such that bn(x) == x * s + b in eval mode."""
    s = weight / torch.sqrt(var + eps)
    return s, bias - mean * s


def _affine(y, a):
    """y (N, C, ...) * a[0] + a[1] per channel, in f32."""
    shape = (1, -1) + (1,) * (y.dim() - 2)
    a = a.float()
    return y * a[0].reshape(shape) + a[1].reshape(shape)


def _conv(x, w, dtype, kernel):
    """f32 conv of f32 ``x`` with ``w`` rounded to ``dtype`` first."""
    w = w.to(dtype).float().reshape(w.shape[0], -1, *kernel)
    return F.conv3d(x, w, padding=(0, kernel[1] // 2, kernel[2] // 2))


def fused_bottleneck_tail_reference(y1, x_res, w2, a2, w3, a3, wp=None,
                                    ap=None):
    """Plain version: (N, Cout, T, H, W) in y1's dtype."""
    check_tail_inputs(y1, x_res, w2, a2, w3, a3, wp, ap)
    dt = y1.dtype
    with torch.autocast(y1.device.type, enabled=False):
        y2 = _conv(y1.float(), w2, dt, (1, 3, 3))
        y2 = torch.relu(_affine(y2, a2)).to(dt).float()
        y3 = _affine(_conv(y2, w3, dt, (1, 1, 1)), a3)
        res = x_res.float()
        if wp is not None:
            res = _affine(_conv(res, wp, dt, (1, 1, 1)), ap)
        return torch.relu(y3 + res).to(dt)


def fused_bottleneck_tail(y1, x_res, w2, a2, w3, a3, wp=None, ap=None):
    """Through the operator ``pretorched::fused_bottleneck_tail``
    (``ops/library.py``): the kernel for CUDA tensors, the plain version on
    the CPU, the operator itself in an exported program."""
    if y1.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no fused bottleneck tail for device {y1.device}')
    check_tail_inputs(y1, x_res, w2, a2, w3, a3, wp, ap)
    if needs_grad(y1, x_res, w2, a2, w3, a3, wp, ap):
        raise ValueError('fused_bottleneck_tail is eval-only: it has no '
                         'backward, and an input requires a gradient')
    return torch.ops.pretorched.fused_bottleneck_tail(y1, x_res, w2, a2, w3,
                                                      a3, wp, ap)


def fused_tail_with_layout(y1, x_res, layout: TailLayout):
    """``fused_bottleneck_tail(y1, x_res, *layout.folded)``; an eager call
    on the card keeps the kernel's weight layout in ``layout`` from call to
    call and launches the kernel directly."""
    if y1.is_cuda and not torch.compiler.is_compiling():
        return fused_bottleneck_tail_laid_out_cuda(y1, x_res, layout)
    return fused_bottleneck_tail(y1, x_res, *layout.folded)
