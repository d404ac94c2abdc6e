"""The training step, on one device or data-parallel over a mesh.

Counterpart of ``pretorched_tpu/parallel/train.py``: cross-entropy, SGD with
momentum and weight decay, and the reference's step-decay schedule
(imagenet_eval.py:162-208, 281-285). The JAX step is one jitted function of
(params, batch_stats, opt_state); here the model and the optimizer hold
that state and the step updates them in place. The JAX step's buffer
donation has no counterpart.

With a mesh (``parallel.mesh``) each rank runs its own rows of the batch:
batch norm normalizes over the rows of every 'data' rank
(``layers.BatchNorm``'s cross-rank statistics, the global batch JAX's
sharded step sees), the gradients are averaged over 'data', and the loss
and top-1 are those of the whole batch. ``zero_axis`` / ``zero_params``
take the model and optimizer of ``parallel.zero.zero_init``.

A 'seq' axis (dp x sp x tp, the JAX dry run's ('data', 'seq', 'model')
mesh) cuts each clip in time as well (``parallel.seq``): x is this rank's
rows and frames (``mesh.global_batch``), batch norm normalizes over 'data'
x 'seq', and each parameter's gradient is summed over 'seq' (each rank
holds its share of it) and averaged over 'data'. A head that
``mesh.place_model`` column-shards over 'model' keeps DTensor parameters:
their local shards are reduced the same way, and SGD steps them in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.layers import set_bn_group
from ..models.resnet3d import checkpointed
from .mesh import axes_group, axis_size, data_group, data_size


def cross_entropy(logits, labels):
    """Mean cross-entropy, with the log-softmax in f32."""
    return F.cross_entropy(logits.float(), labels)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler=None, accum_steps: int = 1, remat=False,
                    mesh=None, zero_axis: Optional[str] = None,
                    zero_params: bool = False) -> Callable:
    """Returns ``step(x, labels) -> {'loss', 'top1'}`` (0-d tensors on the
    model's device; reading them synchronizes, the step does not).

    A step puts the model in train mode, takes the gradient of the mean
    cross-entropy, steps ``optimizer`` and then ``scheduler`` (per step, as
    the JAX schedule counts optimizer updates).

    ``accum_steps > 1`` splits the batch (divisible by it) into microbatches
    run one after another: BN statistics update per microbatch, and the
    gradients are averaged over the microbatches before the one update, as
    the JAX step's ``lax.scan`` does (train.py:99-121).

    ``remat``: ``True`` or a tuple of stages. A model with a ``remat``
    attribute (``VideoResNet``) gets it set, and checkpoints those stages'
    residual blocks; any other model is checkpointed as a whole forward.

    ``mesh``: x and labels are this rank's rows (equal on every rank of
    'data'), and with a 'seq' axis x is also cut in time (call
    ``seq.seq_parallel(model, mesh)`` first); see the module docstring.
    The model's parameters must be replicated (``mesh.place_model`` does
    it, with the head column-sharded over 'model' where it divides) or
    FSDP-sharded. ``zero_axis='data'`` requires the ZeRO optimizer of
    ``zero_init``, and with ``zero_params=True`` its FSDP model too; they
    take no 'seq' axis.
    """
    from .zero import is_fsdp, is_zero

    if accum_steps < 1:
        raise ValueError(f'accum_steps must be >= 1, got {accum_steps}')
    if zero_axis is not None:
        if mesh is None:
            raise ValueError('zero_axis requires a mesh')
        if zero_axis != 'data':
            raise ValueError(f'ZeRO shards over the data axis, not '
                             f'{zero_axis!r}')
        if zero_params != is_fsdp(model) or (not zero_params
                                             and not is_zero(optimizer)):
            raise ValueError('zero_axis needs the model and optimizer of '
                             'parallel.zero.zero_init(..., shard_params='
                             f'{zero_params})')
    elif zero_params:
        raise ValueError('zero_params requires zero_axis')
    if axis_size(mesh, 'seq') > 1:
        if zero_axis is not None:
            raise ValueError('ZeRO and FSDP take no seq axis')
        rules = getattr(model, 'seq', None)
        if rules is None or rules.mesh is not mesh:
            raise ValueError("a mesh with a 'seq' axis needs the model's "
                             'time-sharding rules on it: call parallel.seq.'
                             'seq_parallel(model, mesh) first')
    # the gradients and batch norm reduce over 'data' x 'seq', the metrics
    # over 'data' (every 'seq' rank of a row computes the same loss)
    group = axes_group(mesh, ('data', 'seq'))
    metrics_group = data_group(mesh)
    n_data = data_size(mesh)
    # FSDP reduce-scatters the gradients itself
    all_reduce_grads = group is not None and not is_fsdp(model)
    set_bn_group(model, group)
    forward = model
    if remat and hasattr(model, 'remat'):
        model.remat = remat
    elif remat:
        def forward(x):
            return checkpointed(model, x)

    def step(x, labels) -> Dict[str, torch.Tensor]:
        if x.shape[0] % accum_steps:
            raise ValueError(f'batch {x.shape[0]} not divisible by '
                             f'accum_steps {accum_steps}')
        model.train()
        optimizer.zero_grad(set_to_none=True)
        losses, top1s = [], []
        for xi, li in zip(x.chunk(accum_steps), labels.chunk(accum_steps)):
            logits = forward(xi)
            loss = cross_entropy(logits, li)
            (loss / accum_steps).backward()
            losses.append(loss.detach())
            top1s.append((logits.argmax(1) == li).float().mean())
        metrics = torch.stack([torch.stack(losses).mean(),
                               torch.stack(top1s).mean()])
        if all_reduce_grads:
            _average_gradients(model, group, n_data)
        if metrics_group is not None:
            dist.all_reduce(metrics, group=metrics_group)
            metrics /= n_data
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {'loss': metrics[0], 'top1': metrics[1]}

    return step


@torch.no_grad()
def _average_gradients(model, group, n: int):
    """Every gradient summed over ``group`` and divided by ``n``: one
    all-reduce of the gradients flattened, per dtype. A DTensor gradient
    (a head sharded over 'model') takes part with its local shard."""
    from .zero import _local

    grads = [_local(p.grad) for p in model.parameters() if p.grad is not None]
    for dtype in {g.dtype for g in grads}:
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat /= n
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))


def finetune_mask(model: torch.nn.Module, trainable_prefixes) -> Dict[str, bool]:
    """``{parameter name: trainable}``: True where the name starts with one
    of ``trainable_prefixes`` (from ``models.resnet3d.
    get_fine_tuning_parameter_names``); None trains everything. Hand only
    the trainable parameters to the optimizer, so that frozen ones get no
    update at all, weight decay included::

        mask = finetune_mask(model, get_fine_tuning_parameter_names(4))
        opt, sched = sgd_step_decay(
            [p for n, p in model.named_parameters() if mask[n]], lr=0.01)
    """
    return {name: trainable_prefixes is None
            or any(name.startswith(pref) for pref in trainable_prefixes)
            for name, _ in model.named_parameters()}


def sgd_step_decay(params, lr: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 1e-4, decay_epochs: int = 30,
                   steps_per_epoch: int = 1, start_step: int = 0):
    """``(optimizer, scheduler)``: SGD with momentum, whose ``weight_decay``
    adds ``weight_decay * p`` to the gradient before the momentum trace (the
    JAX ``add_decayed_weights`` then ``sgd``), and the reference's 0.1x every
    ``decay_epochs`` epochs as a per-step staircase (train.py:159-167). Call
    ``scheduler.step()`` once per optimizer step (``make_train_step`` does).
    ``start_step``: the schedule's position at the first step (a resumed
    run's, as the JAX step is passed its ``step_idx``)."""
    optimizer = torch.optim.SGD(params, lr=lr, momentum=momentum,
                                weight_decay=weight_decay)
    return optimizer, step_decay(optimizer, decay_epochs, steps_per_epoch,
                                 start_step)


def step_decay(optimizer, decay_epochs: int = 30, steps_per_epoch: int = 1,
               start_step: int = 0):
    """The reference's 0.1x every ``decay_epochs`` epochs on ``optimizer``
    (any, e.g. the ZeRO one of ``zero.zero_init``) as a per-step staircase
    from ``start_step``."""
    period = decay_epochs * steps_per_epoch
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 0.1 ** ((start_step + step) // period))
