"""Numerical-safety checks.

Counterpart of ``pretorched_tpu/utils/debugging.py``. The reference offers
a debug gradient hook (pretorched/utils.py:129-138). Here:

* ``checked(fn)``: ``fn`` with every ATen op it runs checked as JAX's
  ``checkify.float_checks`` checks it: an op whose output holds a NaN, or
  that divides by zero, raises ``FloatingPointError`` naming the op,
  instead of passing garbage on (an inf, as ``log(0)``'s, passes);
* ``grad_stats(grads)``: mean |grad| per group, the grad-hook analog;
* ``assert_finite(tree)``: raise ``FloatingPointError`` if any tensor of a
  module, a nested dict or a list holds a NaN or an inf.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DIV_OPS = ('div', 'div_', 'remainder', 'fmod')


def _float_tensors(values) -> Iterator[torch.Tensor]:
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            yield v
        elif isinstance(v, (tuple, list)):
            yield from _float_tensors(v)


class _FloatChecks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _DIV_OPS and len(args) > 1:
            divisor = args[1]
            zero = (bool((divisor == 0).any())
                    if isinstance(divisor, torch.Tensor) else divisor == 0)
            if zero:
                raise FloatingPointError(f'division by zero in {name}')
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(bool(torch.isnan(t).any()) for t in _float_tensors(outs)):
            raise FloatingPointError(f'nan generated by {name}')
        return out


def checked(fn: Callable) -> Callable:
    """Returns g(*args) -> fn(*args), raising ``FloatingPointError`` where
    an op inside outputs a NaN or divides by zero."""

    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapper


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, torch.nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield prefix + tuple(name.rsplit('.', 1)), t
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, torch.as_tensor(tree)


def grad_stats(grads) -> Dict[str, float]:
    """Mean |grad| per group: the first two levels of a nested dict's
    path, as the JAX helper keys a flax tree (where the first level is
    the module, the second the leaf), the largest mean where several
    leaves share a key. A module's gradients group the same way, by
    module prefix and parameter name."""
    if isinstance(grads, torch.nn.Module):
        flat = [(tuple(n.rsplit('.', 1)), p.grad)
                for n, p in grads.named_parameters() if p.grad is not None]
    else:
        flat = list(_leaves(grads))
    out: Dict[str, float] = {}
    for path, leaf in flat:
        key = '.'.join(path[:2])
        mean = float(leaf.detach().abs().float().mean())
        out[key] = max(out.get(key, 0.0), mean)
    return out


def assert_finite(tree, name: str = 'tree') -> None:
    """Raise ``FloatingPointError`` naming the first five non-finite
    tensors of ``tree`` (a module's parameters and buffers, a nested dict
    or list of tensors, or one tensor)."""
    bad = ['.'.join(path) for path, leaf in _leaves(tree)
           if leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f'non-finite values in {name}: {bad[:5]}')
