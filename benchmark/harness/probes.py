"""Spans around the model's calls into its kernels' layers, installed in a
traced run only.

Each entry names a function by the program module that looks it up when
the model runs, and the span its calls record. Where a gradient flows,
the span ``<name>.bwd`` runs from the moment the output's gradient
reaches the call to the moment the inputs' gradients leave it: two
identity autograd functions around the call mark its two ends.
"""

from __future__ import annotations

import importlib

import torch

# (module, function, span): K1's caller in the non-local block, K2's in
# the SlowFast bottleneck
PROBES = (('pretorched_tpu_torch.models.nonlocalnet', 'auto_nonlocal_attention',
           'k1'),
          ('pretorched_tpu_torch.models.slowfast', 'fused_tail_with_layout',
           'k2'))


class _Mark(torch.autograd.Function):
    """The identity; its backward opens or closes a span."""

    @staticmethod
    def forward(ctx, spans, name, opens, *tensors):
        ctx.spans, ctx.name, ctx.opens = spans, name, opens
        out = tuple(t.view_as(t) for t in tensors)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *grads):
        (ctx.spans.begin if ctx.opens else ctx.spans.finish)(ctx.name)
        return (None, None, None, *grads)


def _spanned(fn, spans, name):
    def call(*args, **kwargs):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        grad = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in tensors)
        if grad:
            marked = iter(_Mark.apply(spans, f'{name}.bwd', False, *tensors)
                          if len(tensors) > 1 else
                          (_Mark.apply(spans, f'{name}.bwd', False,
                                       *tensors),))
            args = tuple(next(marked) if isinstance(a, torch.Tensor) else a
                         for a in args)
        with spans.span(f'{name}.fwd'):
            out = fn(*args, **kwargs)
        return _Mark.apply(spans, f'{name}.bwd', True, out) if grad else out
    call.__wrapped__ = fn
    return call


def install(spans):
    for module, attr, name in PROBES:
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        if not hasattr(fn, '__wrapped__'):
            setattr(mod, attr, _spanned(fn, spans, name))
