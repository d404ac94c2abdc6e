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
them directly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

HEAD = 'last_linear'


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ('data', 'model'),
              device_type: str = 'cuda'):
    """A ('data', 'model') ``DeviceMesh`` over the processes of the default
    group; with no ``shape``, all of them on 'data'. Without a group (one
    process, no launcher) it starts one of this process alone."""
    from torch.distributed.device_mesh import init_device_mesh

    from .dist import initialize_single

    if not dist.is_initialized():
        initialize_single('nccl' if device_type == 'cuda' else 'gloo')
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f'mesh shape {shape} does not hold the {n} '
                         'processes')
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The extent of ``axis`` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh[axis].size()


def data_size(mesh) -> int:
    return axis_size(mesh, 'data')


def data_group(mesh):
    """The process group of this rank's 'data' axis, or None where the axis
    holds one rank (nothing to reduce)."""
    return mesh['data'].get_group() if data_size(mesh) > 1 else None


def batch_sharding(mesh) -> Tuple[int, int]:
    """(this rank's index on 'data', the axis size): the ``shard_id`` and
    ``num_shards`` of ``batch_iterator``."""
    if data_size(mesh) == 1:
        return 0, 1
    return mesh['data'].get_local_rank(), data_size(mesh)


def global_batch(mesh, x):
    """This rank's rows of a batch every rank holds (a tensor or an
    array): the axis-0 block of its 'data' index, as ``P('data')`` splits
    a global array. The batch must divide the axis (``evaluate.pad_batch``)."""
    index, n = batch_sharding(mesh)
    if n == 1:
        return x
    if len(x) % n:
        raise ValueError(f'batch {len(x)} does not divide the data axis {n}')
    rows = len(x) // n
    return x[index * rows:(index + 1) * rows]


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
