"""Device mesh and model placement over ``torch.distributed``.

Counterpart of ``pretorched_tpu/parallel/mesh.py``: a mesh of ('data',
'model') axes over the processes, one card (or one CPU process) each. The
default policy is the JAX package's:

* the batch is split over 'data' (data parallelism): each rank runs its
  rows, and the steps of ``parallel.evaluate`` and ``parallel.train``
  all-reduce the metric sums and the gradients over 'data';
* the classifier (``last_linear``) is column-sharded over 'model' when the
  class count divides the axis (tensor parallelism of the widest matmul),
  and its logits are gathered on every rank, as GSPMD all-gathers them;
* everything else is replicated.

Where XLA inserts the collectives from shardings, here the steps call them:
one process drives one device, so a rank holds its own rows of a batch.
``global_batch`` cuts a rank's rows from a batch every rank holds;
``datasets.folder.batch_iterator(shard_id=..., num_shards=...)`` loads
them directly. ``sharded_apply`` runs a forward that way and gathers its
outputs (data-parallel serving). ``make_mesh`` takes other axis names too
(('data', 'stage') for ``parallel.pipeline``, ('data', 'expert') for
``parallel.moe``), whose collectives (``sum_replicated``,
``gather_replicated``, ``replicated``) differentiate as JAX's replicated
values do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

HEAD = 'last_linear'


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ('data', 'model'),
              device_type: str = 'cuda'):
    """A ``DeviceMesh`` over the processes of the default group, one axis
    per name (('data', 'model') by default; ('data', 'seq', 'model') for
    ``parallel.seq``); with no ``shape``, all of them on the first axis.
    Without a group (one process, no launcher) it starts one of this
    process alone."""
    from torch.distributed.device_mesh import init_device_mesh

    from .dist import initialize_single

    if not dist.is_initialized():
        initialize_single('nccl' if device_type == 'cuda' else 'gloo')
    n = dist.get_world_size()
    names = tuple(axis_names)
    shape = (tuple(shape) if shape is not None
             else (n,) + (1,) * (len(names) - 1))
    if len(shape) != len(names):
        raise ValueError(f'mesh shape {shape} has {len(shape)} axes, the '
                         f'names {names} {len(names)}')
    if math.prod(shape) != n:
        raise ValueError(f'mesh shape {shape} does not hold the {n} '
                         'processes')
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """The extent of ``axis`` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh[axis].size()


def data_size(mesh) -> int:
    return axis_size(mesh, 'data')


def axis_index(mesh, axis: str) -> int:
    """This rank's index on ``axis`` (0 without a mesh or that axis)."""
    return mesh[axis].get_local_rank() if axis_size(mesh, axis) > 1 else 0


def axis_group(mesh, axis: str):
    """The process group of this rank's ``axis``, or None where the axis
    holds one rank (nothing to reduce)."""
    return mesh[axis].get_group() if axis_size(mesh, axis) > 1 else None


def axes_group(mesh, axes: Sequence[str]):
    """The process group spanning ``axes`` together (the ranks that differ
    only in their index on those axes), or None where they hold one rank.
    Axes the mesh lacks hold one rank each. ('data', 'seq') is the group
    batch norm and the gradient sum of ``parallel.seq`` reduce over."""
    present = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if not present:
        return None
    if len(present) == 1:
        return axis_group(mesh, present[0])
    return mesh[present]._flatten('_'.join(present)).get_group()


def data_group(mesh):
    """The process group of this rank's 'data' axis, or None where the axis
    holds one rank (nothing to reduce)."""
    return axis_group(mesh, 'data')


def batch_sharding(mesh) -> Tuple[int, int]:
    """(this rank's index on 'data', the axis size): the ``shard_id`` and
    ``num_shards`` of ``batch_iterator``."""
    return axis_index(mesh, 'data'), data_size(mesh)


def global_batch(mesh, x):
    """This rank's rows of a batch every rank holds (a tensor or an
    array): the axis-0 block of its 'data' index, as ``P('data')`` splits
    a global array. The batch must divide the axis (``evaluate.pad_batch``).
    On a mesh with a 'seq' axis a clip batch (N, C, T, H, W) is also cut
    in time, the dim-2 block of this rank's 'seq' index, as ``P('data',
    'seq')`` splits JAX's (N, T, H, W, C) clips; labels (1-D) are not."""
    index, n = batch_sharding(mesh)
    if n > 1:
        if len(x) % n:
            raise ValueError(f'batch {len(x)} does not divide the data axis '
                             f'{n}')
        rows = len(x) // n
        x = x[index * rows:(index + 1) * rows]
    s = axis_size(mesh, 'seq')
    if s == 1 or x.ndim < 3:
        return x
    if x.shape[2] % s:
        raise ValueError(f'{x.shape[2]} frames do not divide the seq axis '
                         f'{s}')
    frames = x.shape[2] // s
    index = axis_index(mesh, 'seq')
    return x[:, :, index * frames:(index + 1) * frames]


def model_shardings(mesh, model: torch.nn.Module, head_path: str = HEAD):
    """{parameter name: placement on 'model'}: the head's weight and bias
    ``Shard(0)`` (its output features, the JAX kernel's columns) where the
    class count divides the axis, every other parameter ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    tp = axis_size(mesh, 'model')
    head = getattr(model, head_path, None) if head_path else None
    sharded = (isinstance(head, torch.nn.Linear) and tp > 1
               and head.out_features % tp == 0)
    return {name: Shard(0) if sharded and name.startswith(head_path + '.')
            else Replicate() for name, _ in model.named_parameters()}


def place_model(model: torch.nn.Module, mesh, head_path: str = HEAD):
    """Replicate ``model`` over the mesh (its parameters and buffers
    broadcast from rank 0) and column-shard its head over 'model' where
    ``model_shardings`` says so, with the logits gathered on every rank.
    Returns the model."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   parallelize_module)

    if dist.get_world_size() > 1:
        with torch.no_grad():
            for t in (*model.parameters(), *model.buffers()):
                dist.broadcast(t, src=0)
    placements = model_shardings(mesh, model, head_path)
    if any(p.is_shard() for p in placements.values()):
        parallelize_module(getattr(model, head_path), mesh['model'],
                           ColwiseParallel(output_layouts=Replicate()))
    return model


# The collectives below return what every rank of the group holds alike,
# as a JAX array replicated over the axis is one value: their backward
# takes the gradient of a loss that every rank of the group computes
# alike, so a rank's part gets its own share of it, not the sum over ranks
# that ``torch.distributed.nn.functional`` gives. ``replicated`` marks an
# input every rank holds alike, whose gradient is summed over the ranks'
# uses, as JAX sums the cotangent of a replicated ``shard_map`` input.
class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.index = dist.get_rank(group)
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None


def replicated(x, group):
    """``x``, an input every rank of ``group`` holds alike, whose gradient
    the backward sums over the group (``x`` itself for None or where it
    takes no gradient)."""
    if group is None or not x.requires_grad:
        return x
    return _Replicated.apply(x, group)


def sum_replicated(x, group):
    """The sum of ``x`` over the ranks of ``group`` (``x`` itself for
    None), held by every rank."""
    return x if group is None else _SumReplicated.apply(x, group)


def gather_replicated(x, group):
    """The ranks' ``x`` (equal shapes) concatenated on axis 0 in their
    order in ``group`` (``x`` itself for None), held by every rank."""
    return x if group is None else _GatherReplicated.apply(x, group)


def sharded_apply(apply_fn, mesh):
    """``apply_fn(model, batch)`` data-parallel over the mesh: each rank
    runs its rows of the batch (``global_batch``; the batch is padded with
    its last row to a multiple of the 'data' axis) and the outputs are
    all-gathered, so every rank returns the outputs of the whole batch.

    It serves in ``serving.InferenceServer`` as any ``apply_fn`` does, on a
    mesh of one process. Across processes, every rank must call it on the
    same batches in the same order; one server a rank would not: each
    server's batcher groups requests by their arrival, so two ranks would
    issue different collectives and hang. Call it on the ranks directly."""
    def fn(model, x):
        n = data_size(mesh)
        rows = len(x)
        pad = -rows % n
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        out = apply_fn(model, global_batch(mesh, x))
        return gather_replicated(out, data_group(mesh))[:rows]
    return fn
