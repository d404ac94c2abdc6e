"""ZeRO-sharded optimizer state and FSDP-sharded parameters over 'data'.

Counterpart of ``pretorched_tpu/parallel/zero.py``. The reference's only
multi-device construct replicates everything (``nn.DataParallel``,
examples/imagenet_eval.py:136): every GPU holds the parameters and the
optimizer state whole. Here:

* ZeRO-1 (``shard_params=False``): the parameters stay replicated and the
  gradients are all-reduced as in plain data parallelism (the train step
  does it); the optimizer state is split over the 'data' ranks by
  ``torch.distributed.optim.ZeroRedundancyOptimizer``, which updates each
  parameter on the rank that holds its state and broadcasts it. Per-rank
  optimizer bytes drop to about 1/n. Where the JAX package splits every
  leaf along its largest divisible dimension, this splits the set of
  parameters, whole ones to a rank.
* FSDP (``shard_params=True``): ``torch.distributed.fsdp.fully_shard``
  shards the parameters, and so the gradients and the optimizer state,
  over 'data', each along its largest divisible dimension by the JAX rule
  (``tree_axis_shardings``; dimension 0, padded, where none divides); it
  gathers the parameters for the forward and backward and reduce-scatters
  the gradients.

Either way the numbers are those of the replicated run: sharding is an
implementation detail. Checkpoints are written from rank 0 as full state
dicts (``full_state_dicts``), which ``zoo/checkpoint.py`` saves and any
run restores.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

MIN_SIZE = 2 ** 12


def _leaf_dim(shape, n: int, min_size: int):
    """The dimension of the largest extent divisible by ``n``, or None
    (replicate) for a leaf under ``min_size`` elements or with no such
    dimension (``pretorched_tpu/parallel/zero.py:36-49``)."""
    if math.prod(shape) < min_size:
        return None
    best = None
    for d, extent in enumerate(shape):
        if extent % n == 0 and (best is None or extent > shape[best]):
            best = d
    return best


def _named_tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def tree_axis_shardings(mesh, tree, axis: str = 'data',
                        min_size: int = MIN_SIZE):
    """{name: placement}: each tensor of ``tree`` (a module's parameters or
    a dict of tensors) ``Shard(d)`` over ``axis`` along its largest
    dimension divisible by the axis, small or indivisible ones
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    from .mesh import axis_size

    n = axis_size(mesh, axis)
    out = {}
    for name, t in _named_tensors(tree).items():
        d = _leaf_dim(tuple(t.shape), n, min_size)
        out[name] = Replicate() if d is None else Shard(d)
    return out


def zero_init(model: torch.nn.Module, optimizer_class, mesh,
              axis: str = 'data', shard_params: bool = False,
              min_size: int = MIN_SIZE, **defaults):
    """``(model, optimizer)`` with the optimizer state sharded over
    ``axis`` (ZeRO-1), and with ``shard_params`` the parameters too (FSDP).
    ``optimizer_class(params, **defaults)`` is the optimizer every rank
    would build alone, e.g. ``torch.optim.SGD`` with ``lr=0.1,
    momentum=0.9``. Pair it with ``make_train_step(..., mesh=mesh,
    zero_axis=axis, zero_params=shard_params)``."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from .mesh import place_model

    if axis != 'data':
        raise ValueError(f'ZeRO shards over the data axis, not {axis!r}')
    place_model(model, mesh)
    if shard_params:
        from torch.distributed.fsdp import fully_shard

        rule = tree_axis_shardings(mesh, model, axis, min_size)
        by_param = {id(p): rule[name]
                    for name, p in model.named_parameters()}
        # FSDP cannot replicate: its default, dimension 0, where JAX would
        fully_shard(model, mesh=mesh[axis], shard_placement_fn=lambda p: (
            by_param[id(p)] if by_param[id(p)].is_shard() else None))
        return model, optimizer_class(model.parameters(), **defaults)
    return model, ZeroRedundancyOptimizer(
        model.parameters(), optimizer_class=optimizer_class,
        process_group=mesh[axis].get_group(), **defaults)


def is_fsdp(model) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def is_zero(optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer
    return isinstance(optimizer, ZeroRedundancyOptimizer)


def _local(t):
    return t.to_local() if hasattr(t, 'to_local') else t


def _distributed(model) -> bool:
    """Whether ``model`` holds DTensor parameters: FSDP's, or a head that
    ``mesh.place_model`` sharded over 'model'."""
    return is_fsdp(model) or any(hasattr(p, 'to_local')
                                 for p in model.parameters())


def sharded_size_bytes(tree) -> int:
    """Bytes this rank holds of ``tree``: an optimizer's state (only the
    part a ZeRO optimizer keeps here), a module's parameters or a dict of
    tensors; a sharded tensor counts its local shard."""
    if isinstance(tree, torch.optim.Optimizer):
        inner = getattr(tree, 'optim', tree)
        tensors = [v for state in inner.state.values()
                   for v in state.values() if isinstance(v, torch.Tensor)]
    else:
        tensors = list(_named_tensors(tree).values())
    return sum(_local(t).numel() * t.element_size() for t in tensors)


def full_state_dicts(model, optimizer=None):
    """(model state dict, optimizer state dict or None), whole, on rank 0
    and empty elsewhere; every rank must call it. Plain tensors on the CPU
    for a model with DTensor parameters (FSDP's, a tensor-parallel head's:
    gathered; its optimizer state keyed by parameter name); a ZeRO
    optimizer's state consolidated from every rank."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict, get_optimizer_state_dict)

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if _distributed(model):
        opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
        msd = get_model_state_dict(model, options=opts)
        osd = (None if optimizer is None else
               get_optimizer_state_dict(model, optimizer, options=opts))
        return msd, osd
    msd = model.state_dict() if rank0 else {}
    osd = None
    if optimizer is not None and is_zero(optimizer):
        optimizer.consolidate_state_dict(to=0)
        osd = optimizer.state_dict() if rank0 else {}
    elif optimizer is not None:
        osd = optimizer.state_dict() if rank0 else {}
    return msd, osd


def load_full_state_dict(model, state_dict):
    """Load a whole state dict (as ``full_state_dicts`` or
    ``zoo.convert.state_dict_from_flax`` gives it, on every rank) into
    ``model``, sharded or not."""
    if not _distributed(model):
        model.load_state_dict(state_dict)
        return
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         set_model_state_dict)
    # it replaces the dict's tensors by their shards: keep the caller's
    set_model_state_dict(model, dict(state_dict),
                         options=StateDictOptions(full_state_dict=True))


def load_optimizer_state(model, optimizer, state):
    """Load a whole optimizer state dict (``full_state_dicts``' second) on
    every rank into ``optimizer``, of ``model`` sharded or not."""
    if not _distributed(model):
        optimizer.load_state_dict(state)
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_optimizer_state_dict)
    set_optimizer_state_dict(model, optimizer, state,
                             options=StateDictOptions(full_state_dict=True))
