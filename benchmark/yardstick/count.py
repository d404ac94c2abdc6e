"""Model FLOPs from a list of the products a forward makes.

An architecture's module (``yardstick/<reference>.py``) lists the products
of one clip's forward, from the configuration's sizes alone:

* ``Conv(cin, cout, kernel, out, dgrad)``: a dense 3D convolution with
  output (cout, *out); ``dgrad`` says whether autograd computes its input's
  gradient (not for the stem, whose input is the clip);
* ``Linear(fin, fout)``;
* ``Attention(n, nk, c, cv)``: softmax(q k^T) v, the products q k^T and p v.

A forward costs 2 FLOPs a multiply-add. A training step adds the
backward as autograd computes it on the plain model: each product's input
gradient (where one is taken) and weight gradient, the attention's four
backward products. Recomputation (remat, a kernel that forms s again in
its backward) is not model work and is not counted. Batch norm, pooling
and elementwise work are left out, as ``torch.utils.flop_counter`` leaves
them out.
"""

from __future__ import annotations

import math
from typing import NamedTuple


class Conv(NamedTuple):
    cin: int
    cout: int
    kernel: tuple
    out: tuple
    dgrad: bool = True


class Linear(NamedTuple):
    fin: int
    fout: int


class Attention(NamedTuple):
    n: int
    nk: int
    c: int
    cv: int


def out_size(size, kernel, stride, padding):
    return tuple((s + 2 * p - k) // st + 1
                 for s, k, st, p in zip(size, kernel, stride, padding))


def flops(products, train: bool = False) -> float:
    """FLOPs of one forward (and backward, with ``train``)."""
    total = 0.0
    for op in products:
        if isinstance(op, Conv):
            fwd = 2 * op.cin * op.cout * math.prod(op.kernel) * math.prod(
                op.out)
            total += fwd * (1 + (1 + op.dgrad if train else 0))
        elif isinstance(op, Linear):
            total += 2 * op.fin * op.fout * (3 if train else 1)
        else:
            fwd = 2 * op.n * op.nk * (op.c + op.cv)
            total += fwd * (3 if train else 1)
    return total
