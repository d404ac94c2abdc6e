"""The products the references compute, in one place, so that a control can
compute them in a lower precision.

``Ops`` is plain float32: every convolution and matrix product in float32
with TF32 off (the caller turns it off: ``float32_matmuls``). ``Fp8Ops`` is
the control of a bfloat16 configuration: each operand of every product is
rounded to float8 e4m3 with a per-tensor scale (its largest magnitude
mapped to 448, the format's largest), the product taken in float32, as an
fp8 inference or training step with per-tensor scaling computes it. A
rounding that autograd sees as the identity (straight through), so that
the backward's products take the rounded operands that the forward saved.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_matmuls(tf32: bool = False):
    """Matmuls and cuDNN convolutions in float32, TF32 off (on with
    ``tf32``, the control of a float32 configuration with TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Ops:
    """float32 products."""

    def q(self, t):
        return t

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv3d(self.q(x), self.q(w), b, stride, padding)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def bmm(self, a, b):
        return torch.bmm(self.q(a), self.q(b))


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().float().clamp(min=1e-30)
        scale = 448.0 / amax
        return ((t.float() * scale).to(torch.float8_e4m3fn).float()
                / scale).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


class Fp8Ops(Ops):
    """Every operand rounded to float8 e4m3 with a per-tensor scale."""

    def q(self, t):
        return _RoundFp8.apply(t)
