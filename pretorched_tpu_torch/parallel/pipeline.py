"""Pipeline parallelism: a GPipe executor over stages.

Counterpart of ``pretorched_tpu/parallel/pipeline.py``. The batch is split
into M microbatches and S stages run them in M + S - 1 ticks: at tick t
stage s works on microbatch t - s, and the ticks where t - s falls outside
the M microbatches (warm-up and drain, the bubble of (S - 1) / (M + S - 1))
run no stage. Two transports run that schedule:

* In one process over a list of devices (``devices=[...]``, one a
  stage): stage s's parameters live on ``devices[s]`` and its outputs move
  to ``devices[s + 1]`` with ``.to``, which autograd differentiates.
  ``devices=['cuda:0'] * 4`` runs four stages on one card, one after
  another; the stages do not overlap in time.
* Across the ranks of a ``DeviceMesh`` with a 'stage' dimension (one
  process a device, ``parallel.mesh.make_mesh``): rank s of the stage
  group runs stage s. Every tick each rank sends its last output to rank
  s + 1 and receives rank s - 1's (``_Shift``, point-to-point; its
  backward sends the gradient the other way), where JAX has
  ``lax.ppermute``. A rank with no microbatch at a tick passes its (zero)
  input on and runs no stage, so a stage that is not finite on zeros leaks
  nothing. The last stage's outputs reach every rank through an
  all-reduce of ``torch.where(stage == S - 1, ys, 0)`` (JAX's masked
  ``psum``). With ``batch_axes=('data',)`` each rank pipelines its rows of
  the batch over its stage group (DP x PP) and the outputs are gathered
  over 'data'. Every rank is given the whole batch and returns the whole
  output, as JAX's global arrays are. The backward is that of a loss every
  rank computes alike: the input gets its whole gradient on every rank, as
  a replicated input in JAX; a rank's parameters get the gradient of its
  part (its blocks; with 'data', of its rows, to be summed over 'data' as
  the train step does; in ``pipeline_apply_stages``, of its stage).
  Every rank of the mesh must take the backward, in the same order.

``pipeline_apply`` runs a homogeneous trunk (L blocks of one shape,
parameters stacked on a leading axis and split over the stages, L / S
blocks each: pp as a parameter-memory axis); ``pipeline_apply_stages`` runs
S heterogeneous stages (a ResNet's four resolution stages, each with its
own parameters, replicated: pp as an activation-memory axis).

Batch norm sees each microbatch alone, not the batch (the GPipe caveat):
pipeline a model whose batch norm is in eval mode or has frozen statistics.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import (axis_group, axis_index, axis_size, gather_replicated,
                   replicated, sum_replicated)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


class LocalShard(dict):
    """One rank's block of a tree stacked on a leading axis (what
    ``stage_sharding`` and ``moe.expert_sharding`` return): its leaves hold
    rows ``index * n .. (index + 1) * n`` of the ``total`` rows."""

    def __init__(self, tree, total: int):
        super().__init__(tree)
        self.total = total


def stack_block_params(params_list: Sequence):
    """Stack L blocks' parameters of one structure on a new leading axis:
    nested dicts of tensors or arrays (a JAX pytree as numpy) -> the same
    dict of (L, ...) tensors; L modules -> their parameters and buffers by
    name (``torch.func.stack_module_state``), ready for a block function
    over ``torch.func.functional_call``."""
    params_list = list(params_list)
    if all(isinstance(p, torch.nn.Module) for p in params_list):
        params, buffers = torch.func.stack_module_state(params_list)
        return {**params, **buffers}
    first = params_list[0]
    if isinstance(first, Mapping):
        return {k: stack_block_params([p[k] for p in params_list])
                for k in first}
    return torch.stack([p if torch.is_tensor(p)
                        else torch.from_numpy(np.array(p))
                        for p in params_list])


def _rows(stacked, index: int, parts: int):
    """Rows ``index`` of ``parts`` equal blocks of each leaf's leading axis
    (a view: differentiable with respect to ``stacked``)."""
    total = _first_leaf(stacked).shape[0]
    if total % parts:
        raise ValueError(f'{total} stacked rows do not divide into {parts}')
    n = total // parts
    return _tree_map(lambda leaf: leaf[index * n:(index + 1) * n], stacked)


def _own(leaf, device=None):
    """A leaf of its own storage (a new leaf tensor where ``leaf`` takes a
    gradient), so the whole stack can be freed."""
    own = leaf.detach().to(device).clone()
    return own.requires_grad_(leaf.requires_grad)


def local_rows(stacked, mesh, axis: str):
    """This rank's block of ``stacked`` over ``axis`` as a ``LocalShard``
    (copies of their own), or ``stacked`` as it is if it is one."""
    if isinstance(stacked, LocalShard):
        return stacked
    total = _first_leaf(stacked).shape[0]
    rows = _rows(stacked, axis_index(mesh, axis), axis_size(mesh, axis))
    return LocalShard(_tree_map(_own, rows), total)


def stage_sharding(mesh, stacked, axis: str = 'stage',
                   devices: Optional[Sequence] = None):
    """The leading (block) axis of ``stacked`` split over the stages. With
    ``mesh``: this rank's L/S blocks on its index of ``axis`` (a
    ``LocalShard``, which ``pipeline_apply`` takes as is). In one process
    (``mesh=None``): a list of each device's blocks, on that device."""
    if mesh is not None:
        return local_rows(stacked, mesh, axis)
    return [_tree_map(lambda leaf: _own(leaf, d), _rows(stacked, s,
                                                        len(devices)))
            for s, d in enumerate(devices)]


def _apply_blocks(block_fn, params, h):
    for i in range(_first_leaf(params).shape[0]):
        h = block_fn(_tree_map(lambda leaf: leaf[i], params), h)
    return h


def sequential_apply(block_fn: Callable, stacked_params, x):
    """Oracle: the L blocks applied one after another, in stacking order."""
    return _apply_blocks(block_fn, stacked_params, x)


def _batch_guard(x, dp: int, n_micro: int):
    assert x.shape[0] % (dp * n_micro) == 0, (
        f'batch {x.shape[0]} must divide by data shards ({dp}) x '
        f'microbatches ({n_micro})')


def _data_axis(mesh, batch_axes):
    if len(batch_axes) > 1:
        raise NotImplementedError(f'one batch axis at most, got {batch_axes}')
    if batch_axes and mesh is None:
        raise ValueError('batch_axes need a mesh')
    return batch_axes[0] if batch_axes else None


def _local_schedule(stage_call, xs, devices):
    """The GPipe ticks in one process: ``stage_call(s, h)`` on
    ``devices[s]``; returns the last stage's outputs in microbatch order."""
    S, M = len(devices), len(xs)
    held = [None] * S           # each stage's output of the last tick
    ys = []
    for t in range(M + S - 1):
        for s in reversed(range(S)):     # stage s reads s - 1's last output
            if 0 <= t - s < M:
                h = xs[t - s] if s == 0 else held[s - 1]
                held[s] = stage_call(s, h.to(devices[s]))
        if t >= S - 1:
            ys.append(held[S - 1])
    return ys


class _Shift(torch.autograd.Function):
    """Stage s sends ``x`` to stage s + 1 and returns stage s - 1's tensor
    (zeros on the first stage); the backward sends the gradient from s + 1
    to s. ``lax.ppermute`` with the pairs (i, i + 1)."""

    @staticmethod
    def forward(ctx, x, group, stage: int, stages: int):
        ctx.group, ctx.stage, ctx.stages = group, stage, stages
        return _exchange(x, group, stage, stages, 1)

    @staticmethod
    def backward(ctx, grad):
        return (_exchange(grad, ctx.group, ctx.stage, ctx.stages, -1),
                None, None, None)


def _exchange(x, group, stage, stages, step):
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= stage + step < stages:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(
            group, stage + step), group))
    if 0 <= stage - step < stages:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
            group, stage - step), group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return out


def _mesh_schedule(stage_call, xs, mesh, stage_axis):
    """The GPipe ticks across the ranks of ``stage_axis``: this rank runs
    ``stage_call`` as its stage; returns the last stage's outputs, stacked,
    on every rank."""
    S, stage = axis_size(mesh, stage_axis), axis_index(mesh, stage_axis)
    group = axis_group(mesh, stage_axis)
    M = len(xs)
    first = torch.tensor(stage == 0, device=xs[0].device)
    state = torch.zeros_like(xs[0])
    zero = torch.zeros_like(xs[0])
    ys = []
    for t in range(M + S - 1):
        inp = _Shift.apply(state, group, stage, S) if S > 1 else state
        inp = torch.where(first, xs[t] if t < M else zero, inp)
        state = stage_call(inp) if 0 <= t - stage < M else inp
        if t >= S - 1:
            ys.append(state)
    ys = torch.stack(ys)
    last = torch.tensor(stage == S - 1, device=ys.device)
    return sum_replicated(torch.where(last, ys, torch.zeros_like(ys)), group)


def pipeline_apply(block_fn: Callable, stacked_params, x, mesh=None, *,
                   n_micro: int, stage_axis: str = 'stage',
                   batch_axes: Sequence[str] = (),
                   devices: Optional[Sequence] = None):
    """Apply L stacked blocks to ``x``, pipelined over S stages of L / S
    blocks.

    Args:
      block_fn: ``(one_block_params, x_micro) -> x_micro``, the same shape
        out as in (a homogeneous trunk).
      stacked_params: a dict of (L, ...) tensors (``stack_block_params``).
        With a mesh, this rank's ``stage_sharding`` or the whole stack (each
        rank then keeps a copy of its blocks). In one process, the whole
        stack (sliced differentiably) or ``stage_sharding``'s list.
      x: the (B, ...) batch; B divides by ``n_micro`` times the 'data'
        shards of ``batch_axes``.
      mesh / devices: the transport (see the module docstring): a mesh with
        ``stage_axis``, or a list of S devices.
      n_micro: microbatches M; the bubble is (S - 1) / (M + S - 1).

    Returns the (B, ...) outputs, equal to ``sequential_apply`` (stacking
    order), on the last stage's device (with a mesh: this rank's)."""
    if mesh is None and devices is None:
        raise ValueError('pipeline_apply needs a mesh or devices')
    data_axis = _data_axis(mesh, batch_axes)
    dp = axis_size(mesh, data_axis) if data_axis else 1
    _batch_guard(x, dp, n_micro)
    if mesh is None:
        if isinstance(stacked_params, (list, tuple)):
            per_stage = list(stacked_params)
        else:
            per_stage = [_tree_map(lambda leaf: leaf.to(d), _rows(
                stacked_params, s, len(devices)))
                for s, d in enumerate(devices)]
        ys = _local_schedule(
            lambda s, h: _apply_blocks(block_fn, per_stage[s], h),
            x.chunk(n_micro), devices)
        return torch.cat(ys)
    local = local_rows(stacked_params, mesh, stage_axis)
    group = axis_group(mesh, data_axis) if data_axis else None
    rows = _data_rows(x, mesh, data_axis, stage_axis)
    ys = _mesh_schedule(lambda h: _apply_blocks(block_fn, local, h),
                        list(rows.chunk(n_micro)), mesh, stage_axis)
    return gather_replicated(ys.reshape(rows.shape), group)


def _data_rows(x, mesh, data_axis, stage_axis):
    """This rank's rows of the batch every rank holds, whose gradient sums
    over the stage and data groups."""
    x = replicated(x, axis_group(mesh, stage_axis))
    if data_axis is None:
        return x
    x = replicated(x, axis_group(mesh, data_axis))
    n, i = axis_size(mesh, data_axis), axis_index(mesh, data_axis)
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


def _boundaries(stage_fns, stage_params, x_shape, dtype, device):
    """Each stage boundary's (shape, dtype), from one run of the stage
    functions on fake tensors (shapes and dtypes, no data, nothing
    launched): the counterpart of ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
        h = torch.empty(x_shape, dtype=dtype, device=device)
        bounds = [(tuple(h.shape), h.dtype)]
        for fn, p in zip(stage_fns, stage_params):
            h = fn(p, h)
            bounds.append((tuple(h.shape), h.dtype))
    return bounds


def pipeline_apply_stages(stage_fns: Sequence[Callable], stage_params, x,
                          mesh=None, *, n_micro: int,
                          stage_axis: str = 'stage',
                          batch_axes: Sequence[str] = (),
                          devices: Optional[Sequence] = None):
    """GPipe over S heterogeneous stages, e.g. a ResNet's four resolution
    stages (``models.resnet3d.pipeline_stage_fns`` and
    ``split_stage_variables``), whose shapes and parameters all differ.

    ``stage_fns[i](stage_params[i], x_micro) -> y_micro``. In one process
    stage i runs on ``devices[i]`` with its parameters moved there. Across
    a mesh rank i of the stage axis runs stage i (the parameters are
    replicated: pp as an activation-memory axis), and activations travel
    as flat buffers padded to the largest boundary, whose shapes come from
    one run on fake tensors; the boundaries must share one dtype.
    ``batch_axes=('data',)`` composes with data parallelism as in
    ``pipeline_apply``.

    Returns the last stage's outputs for the whole batch, equal to the
    stages composed in order."""
    if mesh is None and devices is None:
        raise ValueError('pipeline_apply_stages needs a mesh or devices')
    S = axis_size(mesh, stage_axis) if mesh is not None else len(devices)
    assert len(stage_fns) == S == len(stage_params), (len(stage_fns), S)
    data_axis = _data_axis(mesh, batch_axes)
    dp = axis_size(mesh, data_axis) if data_axis else 1
    _batch_guard(x, dp, n_micro)
    if mesh is None:
        params = [_tree_map(lambda leaf: leaf.to(d), p)
                  for p, d in zip(stage_params, devices)]
        ys = _local_schedule(lambda s, h: stage_fns[s](params[s], h),
                             x.chunk(n_micro), devices)
        return torch.cat(ys)

    rows = _data_rows(x, mesh, data_axis, stage_axis)
    micro = rows.shape[0] // n_micro
    bounds = _boundaries(stage_fns, stage_params,
                         (micro,) + tuple(x.shape[1:]), x.dtype, x.device)
    dtypes = {dtype for _, dtype in bounds}
    assert len(dtypes) == 1, f'stage boundaries must share a dtype: {dtypes}'
    sizes = [int(np.prod(shape)) for shape, _ in bounds]
    width = max(sizes)
    s = axis_index(mesh, stage_axis)

    def run(buf):
        h = buf[:sizes[s]].reshape(bounds[s][0])
        y = stage_fns[s](stage_params[s], h).reshape(-1)
        return F.pad(y, (0, width - sizes[s + 1]))

    xs = [F.pad(m.reshape(-1), (0, width - sizes[0]))
          for m in rows.chunk(n_micro)]
    ys = _mesh_schedule(run, xs, mesh, stage_axis)[:, :sizes[-1]]
    ys = ys.reshape((n_micro * micro,) + bounds[-1][0][1:])
    return gather_replicated(ys, axis_group(mesh, data_axis)
                             if data_axis else None)
