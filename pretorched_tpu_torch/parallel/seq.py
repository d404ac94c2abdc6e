"""Time sharding ('seq'): the VideoResNet family on shards of its clips.

The JAX package has no module for this. Its dry run (``__graft_entry__.py:
92-146``) shards a clip batch ``P('data', 'seq')`` and leaves the rest to
XLA, which partitions every op and inserts the collectives. Here the rules
are written by hand. A clip of T frames is cut into S contiguous shards of
T / S frames, in rank order on 'seq', and every op whose temporal window
or stride crosses a shard border is handled:

* **halo exchange**: an op with temporal kernel k, padding p and stride s
  on a shard whose length L is a multiple of s gets ``p`` frames from the
  shard before and ``k - p - s`` from the shard after (none where that is
  negative), and runs with temporal padding 0. The first and last shards
  pad with the op's own value: 0 for a conv, -inf for the max pool. The
  7x7x7 stem takes (3, 3), the 3x3x3/2 pool (1, 0), a block's 3x3x3 conv
  (1, 1) at stride 1 and (1, 0) at stride 2; the backward sends the halo
  gradients back and adds them;
* **short shards**: where L is not a multiple of the stride or is shorter
  than a halo, the activation is all-gathered over 'seq' and the op runs
  on the whole clip, on every rank alike; the activation is split again
  after the op (the stem pool, a residual block, a non-local block) where
  its length divides S, else it stays whole up to the head. A residual
  block is one op for this rule, so that its strided conv and its
  shortcut (A's strided slice, B's 1x1x1 conv) see the same frames;
* **non-local blocks**: theta stays local; phi and g are all-gathered
  over 'seq' in rank order, which keeps the flattened (T, H, W) key order,
  so K1 runs with this shard's queries against every key (N != Nk); the
  gather's backward sums each rank's gradient of the keys back to their
  owner. A ``sub_sample`` pool runs before the gather, locally where L is
  even;
* **head**: the global average pool sums each shard's (T, H, W) in f32
  (f64 for f64 features), adds the sums over 'seq' and divides by the
  whole clip's count;
* **batch norm** normalizes over 'data' x 'seq' (``layers.BatchNorm.
  process_group`` with ``mesh.axes_group``): whole activations count once
  per rank on both sides of the quotient, so their statistics are right.

Gradients. Every collective's backward is its adjoint (all-gather and a
sum back, all-reduce and all-reduce, a send and a receive), and the
logits' gradient is divided by S on the way in. So a loss that every
'seq' rank computes alike from the logits gives each rank its share of
every gradient, and the sum of the shares over 'seq' is the gradient of
that loss: ``parallel.train`` sums every parameter's gradient over 'seq'
(the head's and those after a short-shard gather included) and averages
over 'data'. (An identity backward at the pool, with no division, would
give the parameters before it their share but those after it, the head's
among them, the whole gradient on every rank: summing over 'seq' then
scales them by S, the defect of the JAX reference on a ('data', 'seq',
'model') mesh, ``ROADMAP.md``.)

``seq_parallel(model, mesh)`` installs the rules, once, before
``train.make_train_step(..., mesh=mesh)``: the model's ``seq`` attribute,
forward hooks on its windowed convs and its blocks, and its ``_stem_pool``
and ``_logits`` replaced on the instance. Each rank then takes its rows
and frames of the clips (``mesh.global_batch``). ``seq_parallel(model,
shards=S)`` is the one-process form: the S shards stacked along the batch
dimension of one tensor, (S B, C, T / S, H, W), the exchanges shifts
between the stacked shards; the model takes the whole clips and stacks
them itself (the stem conv's hook). One device then runs exactly the
per-rank arithmetic: K1 at the stacked per-rank shapes, never the
unsharded call.

Scope: ``VideoResNet`` (basic and bottleneck blocks, shortcut A and B) and
``NonLocalResNet3D`` (embedded Gaussian blocks). Any other module raises a
``ValueError`` naming it (``ROADMAP.md`` queue 1). A ``remat`` block's
recompute replays the gather decision of its forward, and repeats its
exchanges in the same order on every rank. Stage slices are refused.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm, set_bn_group, stats_frozen
from ..models.nonlocalnet import NonLocalBlock, NonLocalResNet3D, _Pool2
from ..models.resnet3d import BasicBlock, Bottleneck, VideoResNet
from ..ops.pooling import global_avg_pool, max_pool
from .mesh import axes_group, axis_group, axis_index, axis_size

SEQ = 'seq'
_MODELS = (VideoResNet, NonLocalResNet3D)
_LEAVES = (nn.Conv3d, BatchNorm, nn.Linear, nn.Sequential, _Pool2)
_BLOCKS = (BasicBlock, Bottleneck)


def halo(k: int, p: int, s: int):
    """(left, right) frames a shard needs from its neighbours for an op of
    temporal kernel k, padding p and stride s."""
    return p, max(k - p - s, 0)


def _short(length: int, k: int, p: int, s: int) -> bool:
    """Whether a shard of ``length`` frames cannot run the op locally."""
    return length % s != 0 or length < max(halo(k, p, s))


def _window(conv: nn.Conv3d):
    return conv.kernel_size[0], conv.padding[0], conv.stride[0]


# ----------------------------------------------------------- the exchanges
class _Stacked:
    """S shards stacked on the batch dimension of one tensor."""

    def __init__(self, shards: int):
        self.shards = shards

    def enter(self, x):
        """The whole clips (B, C, T, H, W) as stacked shards."""
        if x.shape[2] % self.shards:
            raise ValueError(f'{x.shape[2]} frames do not divide into '
                             f'{self.shards} shards')
        return self.split(x)

    def _unstack(self, x):
        return x.unflatten(0, (self.shards, -1))

    def halo(self, x, left: int, right: int, value: float):
        xs = self._unstack(x)
        length = xs.shape[3]
        parts = []
        if left:
            prev = xs[:-1, :, :, length - left:]
            parts.append(torch.cat([xs.new_full((1, *prev.shape[1:]), value),
                                    prev]))
        parts.append(xs)
        if right:
            nxt = xs[1:, :, :, :right]
            parts.append(torch.cat([nxt, xs.new_full((1, *nxt.shape[1:]),
                                                     value)]))
        return torch.cat(parts, dim=3).flatten(0, 1)

    def gather(self, x):
        """The whole clips (B, C, S L, H, W) of stacked shards."""
        xs = self._unstack(x)
        return xs.permute(1, 2, 0, *range(3, xs.dim())).flatten(2, 3)

    def split(self, x):
        """Stacked shards of whole clips."""
        xs = x.unflatten(2, (self.shards, -1))
        return xs.permute(2, 0, 1, *range(3, xs.dim())).flatten(0, 1)

    def keys(self, x):
        """Each shard's copy of every shard's frames, in clip order."""
        whole = self.gather(x)
        return whole.expand(self.shards, *whole.shape).flatten(0, 1)

    def sum(self, x):
        return self._unstack(x).sum(0)

    def logits(self, logits):
        return logits


class _Ranks:
    """One shard a rank of the 'seq' group."""

    def __init__(self, group, index: int, shards: int):
        self.group, self.index, self.shards = group, index, shards

    def enter(self, x):
        return x

    def rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index)

    def p2p(self, to_prev, to_next, like_prev, like_next):
        """Send ``to_prev`` to the rank before and ``to_next`` to the rank
        after; receive from them tensors shaped like ``like_prev`` and
        ``like_next`` (None for nothing, and at the ends of the group)."""
        ops, got = [], [None, None]
        for side, send, like in ((-1, to_prev, like_prev),
                                 (1, to_next, like_next)):
            peer = self.index + side
            if not 0 <= peer < self.shards:
                continue
            if send is not None:
                ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                      self.rank(peer), self.group))
            if like is not None:
                got[side > 0] = like.new_empty(like.shape)
                ops.append(dist.P2POp(dist.irecv, got[side > 0],
                                      self.rank(peer), self.group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return got

    def halo(self, x, left: int, right: int, value: float):
        return _Halo.apply(x, left, right, value, self)

    def gather(self, x):
        return _Gather.apply(x, self)

    def split(self, x):
        length = x.shape[2] // self.shards
        return x[:, :, self.index * length:(self.index + 1) * length]

    def keys(self, x):
        return self.gather(x)

    def sum(self, x):
        return _Sum.apply(x, self.group)

    def logits(self, logits):
        return _ShareGrad.apply(logits, self.shards)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, value, ranks):
        ctx.left, ctx.right, ctx.ranks = left, right, ranks
        length = x.shape[2]
        x = x.contiguous()
        head, tail = x[:, :, :right], x[:, :, length - left:]
        got_prev, got_next = ranks.p2p(head if right else None,
                                       tail if left else None,
                                       tail if left else None,
                                       head if right else None)
        parts = []
        if left:
            parts.append(got_prev if got_prev is not None
                         else torch.full_like(tail, value))
        parts.append(x)
        if right:
            parts.append(got_next if got_next is not None
                         else torch.full_like(head, value))
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, grad):
        left, right = ctx.left, ctx.right
        length = grad.shape[2] - left - right
        g_left = grad[:, :, :left]
        g_right = grad[:, :, left + length:]
        out = grad[:, :, left:left + length].clone()
        # the halo gradients go back to the frames they came from
        from_prev, from_next = ctx.ranks.p2p(
            g_left if left else None, g_right if right else None,
            g_right if right else None, g_left if left else None)
        if from_prev is not None:
            out[:, :, :right] += from_prev
        if from_next is not None:
            out[:, :, length - left:] += from_next
        return out, None, None, None, None


class _Gather(torch.autograd.Function):
    """All-gather along time; the backward sums every rank's gradient of
    the whole and keeps this rank's frames."""

    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks, ctx.length = ranks, x.shape[2]
        parts = [torch.empty_like(x) for _ in range(ranks.shards)]
        dist.all_gather(parts, x.contiguous(), group=ranks.group)
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.ranks.group)
        lo = ctx.ranks.index * ctx.length
        return grad[:, :, lo:lo + ctx.length], None


class _Sum(torch.autograd.Function):
    """All-reduce whose backward all-reduces too (its adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ShareGrad(torch.autograd.Function):
    """Identity whose backward divides by ``shares``: each of S ranks that
    compute the logits alike takes 1/S of their gradient."""

    @staticmethod
    def forward(ctx, x, shares):
        ctx.shares = shares
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.shares, None


# ---------------------------------------------------------------- the rules
class SeqRules:
    """The time-sharding rules of one model (``model.seq``). ``whole``:
    the activation stream is whole on every rank (after a short-shard
    gather whose result did not split again)."""

    def __init__(self, shards, mesh=None):
        self.shards = shards         # _Stacked or _Ranks
        self.mesh = mesh             # the mesh of _Ranks; None when stacked
        self.whole = False
        self.windows = {}            # conv -> its temporal (k, p, s)
        self.blocks = {}             # block -> its convs' windows, stride
        self.entry = {}              # block -> ``whole`` as its forward began

    @property
    def count(self) -> int:
        return self.shards.shards

    def _gather(self, x):
        self.whole = True
        return self.shards.gather(x)

    def _resplit(self, x):
        if self.whole and x.shape[2] % self.count == 0:
            self.whole = False
            return self.shards.split(x)
        return x

    def enter(self, x):
        """A forward begins: this rank's frames (the stacked shards of the
        whole clips in one process)."""
        self.whole = False
        return self.shards.enter(x)

    def max_pool(self, x, k: int, s: int, p: int):
        if not self.whole and _short(x.shape[2], k, p, s):
            x = self._gather(x)
        if self.whole:
            return self._resplit(max_pool(x, k, s, p))
        x = self.shards.halo(x, *halo(k, p, s), float('-inf'))
        return max_pool(x, k, s, (0, p, p))

    def logits(self, model, features):
        """The model's ``_logits``: the head pool over the whole clip."""
        if self.whole:
            pooled = global_avg_pool(features)
        else:
            count = features[0, 0].numel() * self.count
            dtype = torch.promote_types(features.dtype, torch.float32)
            with torch.autocast(features.device.type, enabled=False):
                sums = self.shards.sum(features.to(dtype).sum((2, 3, 4)))
            pooled = (sums / count).to(features.dtype)
        return self.shards.logits(model.last_linear(pooled))

    # hooks
    def _whole_forward(self, model, args, kwargs):
        cut = args[1] if len(args) > 1 else kwargs.get('stage_slice')
        if cut is not None and tuple(cut) != (0, 4):
            raise ValueError('a time-sharded model runs whole forwards; '
                             f'stage_slice {tuple(cut)} is not supported')

    def _stem(self, conv, args):
        return self._conv(conv, (self.enter(args[0]),))

    def _conv(self, conv, args):
        (x,) = args
        k, p, s = self.windows[conv]
        if not self.whole and _short(x.shape[2], k, p, s):
            x = self._gather(x)       # the stem on a short shard
        if self.whole:
            return (F.pad(x, (0, 0, 0, 0, p, p)),)
        left, right = halo(k, p, s)
        if left or right:
            return (self.shards.halo(x, left, right, 0.0),)
        return (x,)

    def _block_short(self, block, length: int) -> bool:
        windows, stride = self.blocks[block]
        if length % stride:
            return True
        for k, p, s in windows:
            if _short(length, k, p, s):
                return True
            length //= s
        return False

    def _block_in(self, block, args):
        (x,) = args
        if stats_frozen():            # a remat recompute: as its forward
            self.whole = self.entry[block]
        else:
            self.entry[block] = self.whole
        if not self.whole and self._block_short(block, x.shape[2]):
            return (self._gather(x),)
        return None

    def _block_out(self, block, args, out):
        return self._resplit(out)

    def _nonlocal_in(self, block, args):
        (x,) = args
        if (not self.whole and block.sub_sample
                and _short(x.shape[2], 2, 0, 2)):
            return (self._gather(x),)
        return None

    def _keys(self, module, args, out):
        return out if self.whole else self.shards.keys(out)

    def install(self, model):
        """Hook the rules into ``model``; a ``VideoResNet`` family model
        also enters its shards at the stem conv, and takes its stem pool
        and head pool from the rules."""
        stem = getattr(model, 'conv1', None) if isinstance(model, _MODELS) \
            else None
        for m in model.modules():
            if isinstance(m, nn.Conv3d) and _window(m) != (1, 0, 1):
                self.windows[m] = _window(m)
                m.padding = (0, *m.padding[1:])
                m.register_forward_pre_hook(self._stem if m is stem
                                            else self._conv)
            elif isinstance(m, _BLOCKS):
                convs = [_window(c) for n, c in m.named_children()
                         if n.startswith('conv')]
                self.blocks[m] = ([w for w in convs if w != (1, 0, 1)],
                                  m.stride)
                m.register_forward_pre_hook(self._block_in)
                m.register_forward_hook(self._block_out)
            elif isinstance(m, NonLocalBlock):
                m.register_forward_pre_hook(self._nonlocal_in)
                m.register_forward_hook(self._block_out)
                m.g.register_forward_hook(self._keys)
                m.phi.register_forward_hook(self._keys)
        if stem is not None:
            model.register_forward_pre_hook(self._whole_forward,
                                            with_kwargs=True)
            model._stem_pool = functools.partial(self.max_pool, k=3, s=2, p=1)
            model._logits = functools.partial(self.logits, model)
        model.seq = self


def _check_scope(model: nn.Module) -> None:
    """Raise a ``ValueError`` naming the first module of ``model`` that the
    time-sharding rules do not cover."""
    def refuse(name, what):
        raise ValueError(
            f'parallel.seq has no time-sharding rule for {name} ({what}); it '
            'takes VideoResNet (basic and bottleneck blocks, shortcut A or '
            'B) and NonLocalResNet3D (embedded Gaussian blocks): see '
            'ROADMAP.md queue 1')

    if type(model) not in _MODELS:
        refuse('the model', type(model).__name__)
    for name, m in model.named_modules():
        if m is model:
            continue
        if isinstance(m, _BLOCKS):
            if m.preact:
                refuse(name, 'a pre-activation block')
        elif isinstance(m, NonLocalBlock):
            if m.mode != 'embedded_gaussian':
                refuse(name, f'a non-local block in {m.mode!r} mode')
        elif type(m) not in _LEAVES:
            refuse(name, type(m).__name__)
        elif isinstance(m, nn.Conv3d) and (m.groups != 1
                                           or m.padding_mode != 'zeros'):
            refuse(name, f'a conv with groups={m.groups}, padding_mode='
                         f'{m.padding_mode!r}')


def seq_parallel(model: nn.Module, mesh=None,
                 shards: Optional[int] = None) -> nn.Module:
    """Run ``model`` on time shards of its clips; returns the model.

    ``mesh``: a mesh whose 'seq' axis holds 2 ranks or more; each rank then
    calls the model on its rows and frames (``mesh.global_batch``), and
    batch norm normalizes over 'data' x 'seq'. ``shards``: the one-process
    form, S >= 2 shards stacked on the batch dimension; the model takes
    whole clips. A model is installed once."""
    if (mesh is None) == (shards is None):
        raise ValueError('seq_parallel takes a mesh or a shard count')
    if getattr(model, 'seq', None) is not None:
        raise ValueError('the model is time-sharded already')
    count = axis_size(mesh, SEQ) if mesh is not None else shards
    if count < 2:
        raise ValueError(f'{count} time shard: nothing to shard (the mesh\'s '
                         "'seq' axis or shards must be >= 2)")
    _check_scope(model)
    if mesh is not None:
        exchange = _Ranks(axis_group(mesh, SEQ), axis_index(mesh, SEQ), count)
        set_bn_group(model, axes_group(mesh, ('data', SEQ)))
    else:
        exchange = _Stacked(shards)
    SeqRules(exchange, mesh).install(model)
    return model
