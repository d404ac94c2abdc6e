"""Image and multi-clip evaluation steps, on one device or over a mesh.

Counterpart of ``pretorched_tpu/parallel/evaluate.py``. Without a mesh a
step runs the batch on the model's device. With a mesh (``parallel.mesh``)
each rank runs its own rows of the batch (``mesh.global_batch``, or a
rank-sharded loader) and the metric sums are all-reduced over 'data', so
every rank returns the sums of the whole batch, as the JAX steps do with
the batch sharded over 'data'. All steps treat ``label == -1`` as padding,
masked out of every metric sum including 'count', and ``pad_batch`` pads a
ragged batch with such rows to the data-axis multiple.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.profiling import span
from .mesh import data_group, place_model  # noqa: F401  (JAX's home of it)


def pad_batch(x: torch.Tensor, labels, multiple: int):
    """Pad (x, labels) along axis 0 to a multiple of ``multiple``; padded
    rows get label -1. x stays on its device."""
    n = len(labels)
    if multiple <= 1 or n % multiple == 0:
        return x, labels
    pad = multiple - n % multiple
    x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    labels = np.concatenate([np.asarray(labels),
                             np.full((pad,), -1, np.asarray(labels).dtype)])
    return x, labels


def _masked_metrics(logits, labels, topk):
    """top-k correct sums + NLL sum + count, rows with label -1 masked out."""
    labels = labels.to(logits.device)
    valid = labels >= 0
    safe = labels.clamp(min=0)
    logp = F.log_softmax(logits.float(), dim=1)
    loss = -logp.gather(1, safe[:, None])[:, 0]
    # stable: tied classes rank lowest index first, as JAX's argsort does
    order = torch.argsort(-logits, dim=1, stable=True)[:, :max(topk)]
    correct = (order == safe[:, None]) & valid[:, None]
    out = {f'top{k}': correct[:, :k].any(dim=1).sum() for k in topk}
    out['loss'] = torch.where(valid, loss, torch.zeros_like(loss)).sum()
    out['count'] = valid.sum()
    return out


def _reduced(out, mesh):
    """The metric sums of every rank of 'data' (one all-reduce)."""
    group = data_group(mesh)
    if group is None:
        return out
    keys = list(out)
    sums = torch.stack([out[k].double() for k in keys])
    dist.all_reduce(sums, group=group)
    return {k: sums[i].to(out[k].dtype) for i, k in enumerate(keys)}


def sharded_accuracy_step(model, mesh=None, topk=(1, 5)):
    """One-crop image evaluation. ``step(x, labels)``: x (B, C, H, W) on
    the model's device (with a mesh, this rank's rows), labels (B,) with
    -1 for padding; returns a dict of device scalars (``top1``, ``top5``,
    ``loss``, ``count``), summed over the mesh's 'data' ranks."""

    @torch.inference_mode()
    def step(x, labels):
        return _reduced(_masked_metrics(model(x), torch.as_tensor(labels),
                                        topk), mesh)

    return step


def make_eval_step(model, mesh=None, topk=(1, 5)):
    """The eval step bound to a model (``sharded_accuracy_step``)."""
    return sharded_accuracy_step(model, mesh=mesh, topk=topk)


def multi_clip_eval_step(model, mesh=None, topk=(1, 5)):
    """N-clip video evaluation (BASELINE config 4's protocol).

    Consensus: per-clip softmax probabilities are averaged over clips;
    accuracy and loss (NLL of the consensus probability) come from that
    average. ``step(clips, labels)``: clips (B, N_clips, C, T, H, W) on the
    model's device (with a mesh, this rank's videos), labels (B,) with -1
    for padding; returns a dict of device scalars (``top1``, ``top5``,
    ``loss``, ``count``), summed over the mesh's 'data' ranks. Each call is
    the span ``eval.step``."""

    @torch.inference_mode()
    @span('eval.step')
    def step(clips, labels):
        b, n = clips.shape[:2]
        logits = model(clips.reshape((b * n,) + tuple(clips.shape[2:])))
        logits = logits.reshape(b, n, -1).float()
        probs = F.softmax(logits, dim=-1).mean(dim=1)
        logp = torch.log(probs.clamp(min=1e-30))
        return _reduced(_masked_metrics(logp, torch.as_tensor(labels), topk),
                        mesh)

    return step
