"""Expert parallelism: a Switch-style top-1 mixture of experts, and the
MSTRN relation head run as experts.

Counterpart of ``pretorched_tpu/parallel/moe.py``:

* Router: top-1 ``argmax(x @ router_w)`` a token (ties to the first
  expert, as ``jnp.argmax``), gate from the f32 softmax.
* Capacity: an expert takes at most C = ceil(T / E * capacity_factor)
  tokens; a token's place in its expert's queue comes from an f32
  ``cumsum``, and a token past C is dropped (a zero output row).
* Dispatch and combine are one-hot products, ``(T, E, C) x (T, d) -> (E, C,
  d)`` and back; the output is cast back to ``x.dtype``.
* ``aux_load_balancing_loss``: E * sum_e(f_e * p_e), 1 at uniform routing.

With a mesh that has an 'expert' dimension each rank runs only its own
experts (``expert_sharding``: E / n of them) on its rows of the (E, C, d)
dispatch, and the expert outputs are all-gathered
(``mesh.gather_replicated``), so the combine on every rank sees all of
them; JAX gets the same from ``with_sharding_constraint``. Every rank holds
the tokens and the router and returns the whole output. The backward is
that of a loss every rank computes alike: the tokens and the router get
their whole gradient on every rank, a rank's experts that of their part.

The MSTRN head (``models.trn.MultiScaleRelation``) is a mixture whose
router is fixed: expert ``si`` is the relation MLP of scale k = n - si, its
tokens each video's first ``min(num_relations, C(n, k))`` k-frame
combinations (``mstrn_expert_spec``, ``mstrn_expert_apply``,
``trn_expert_forward``).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import (axis_group, axis_index, axis_size, gather_replicated,
                   replicated)
from .pipeline import local_rows


def expert_sharding(mesh, stacked_params, axis: str = 'expert'):
    """This rank's experts: its block of the leading (expert) axis of
    ``stacked_params`` on ``axis`` (a ``pipeline.LocalShard``)."""
    return local_rows(stacked_params, mesh, axis)


def moe_dispatch(router_logits, capacity: int):
    """Top-1 dispatch and combine tensors from router logits (T, E).

    Returns (dispatch (T, E, C) f32 of 0 and 1, combine (T, E, C) f32,
    metrics). A token past its expert's capacity has all-zero rows in
    both."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    onehot = F.one_hot(router_logits.argmax(-1), E).float()       # (T, E)
    # each token's place in its expert's queue (0-based)
    position = torch.cumsum(onehot, dim=0) * onehot - onehot
    pos = position.sum(-1).long()                                  # (T,)
    keep = (pos < capacity).float()
    slot = F.one_hot(pos.clamp(max=capacity - 1), capacity).float()
    dispatch = (onehot * keep[:, None])[:, :, None] * slot[:, None, :]
    gate = (probs * onehot).sum(-1)
    combine = dispatch * gate[:, None, None]
    metrics = {'fraction_dropped': 1.0 - keep.mean(),
               'router_probs': probs, 'expert_onehot': onehot}
    return dispatch, combine, metrics


def aux_load_balancing_loss(metrics):
    """Switch Transformer load-balancing loss E * sum_e(f_e * p_e): f_e the
    fraction of tokens routed to expert e, p_e its mean router
    probability; 1 at uniform routing, more when skewed."""
    probs, onehot = metrics['router_probs'], metrics['expert_onehot']
    return probs.shape[-1] * (onehot.mean(0) * probs.mean(0)).sum()


def _experts(expert_fn, params, x):
    """``expert_fn`` of each expert of ``params`` on its rows of ``x``."""
    return torch.stack([expert_fn({k: v[e] for k, v in params.items()},
                                  x[e]) for e in range(x.shape[0])])


def moe_apply(expert_fn: Callable, stacked_params, x, router_w, mesh=None,
              *, expert_axis: str = 'expert', capacity_factor: float = 1.25):
    """Top-1 MoE over tokens ``x`` (T, d) with E stacked experts.

    Args:
      expert_fn: ``(one_expert_params, (C, d)) -> (C, d_out)``.
      stacked_params: a dict of (E, ...) tensors (``stack_block_params``);
        with a mesh, the whole stack or this rank's ``expert_sharding``.
      router_w: (d, E) router weights.
      mesh: with an ``expert_axis`` of n ranks, each runs E / n experts.
      capacity_factor: C = ceil(T / E * factor); tokens past C are dropped.

    Returns (y (T, d_out), aux_loss, {'fraction_dropped', 'capacity'})."""
    T, E = x.shape[0], router_w.shape[-1]
    capacity = int(math.ceil(T / E * capacity_factor))
    dispatch, combine, metrics = moe_dispatch(x @ router_w, capacity)
    expert_in = torch.einsum('tec,td->ecd', dispatch, x.float())  # (E, C, d)
    if axis_size(mesh, expert_axis) > 1:
        group = axis_group(mesh, expert_axis)
        local = expert_sharding(mesh, stacked_params, expert_axis)
        n = expert_in.shape[0] // axis_size(mesh, expert_axis)
        lo = axis_index(mesh, expert_axis) * n
        expert_in = replicated(expert_in, group)[lo:lo + n]
        expert_out = gather_replicated(_experts(expert_fn, local, expert_in),
                                       group)
    else:
        expert_out = _experts(expert_fn, stacked_params, expert_in)
    y = torch.einsum('tec,ecd->td', combine, expert_out.float())
    return y.to(x.dtype), aux_load_balancing_loss(metrics), {
        'fraction_dropped': metrics['fraction_dropped'],
        'capacity': capacity}


def moe_reference(expert_fn, stacked_params, x, router_w,
                  capacity_factor: float = 1.25):
    """Per-token oracle (a Python loop over tokens; small inputs only):
    numpy (T, d_out) in ``x``'s dtype."""
    T, E = x.shape[0], router_w.shape[-1]
    capacity = int(math.ceil(T / E * capacity_factor))
    with torch.no_grad():
        logits = x @ router_w
        probs = torch.softmax(logits.float(), dim=-1)
        counts, outs = [0] * E, []
        for t in range(T):
            e = int(logits[t].argmax())
            if counts[e] >= capacity:
                outs.append(None)
                continue
            counts[e] += 1
            y = expert_fn({k: v[e] for k, v in stacked_params.items()},
                          x[t:t + 1])[0]
            outs.append(y.float().cpu().numpy() * float(probs[t, e]))
    d_out = next(o for o in outs if o is not None).shape[-1]
    return np.stack([o if o is not None else np.zeros(d_out, np.float32)
                     for o in outs]).astype(x.cpu().numpy().dtype)


# ---------------------------------------------------------------------------
# The MSTRN relation head as experts (reference trn.py:59-113)

def mstrn_expert_spec(num_inputs: int, num_relations: int = 3,
                      pad_experts_to: Optional[int] = None):
    """The static dispatch of ``MultiScaleRelation`` as experts: expert
    ``si`` is scale k = ``num_inputs - si``, its K tokens a video's first
    ``min(num_relations, C(n, k))`` k-frame combinations (the module's
    path without a generator). Scales differ in width (k * d), so inputs
    and first-layer weights are zero-padded to n * d: exact, because
    ``Relation`` applies ReLU before its first linear and the padded rows
    are zero.

    Returns numpy tables ``sel`` (E, K, n) frame indices, ``frame_mask``
    and ``token_mask`` zeroing padded frames and combinations, the live
    ``scales``, and E, K, ``num_inputs``. ``pad_experts_to`` appends
    all-zero experts so that E divides a mesh's expert axis."""
    scales = list(range(num_inputs, 1, -1))
    E = pad_experts_to or len(scales)
    assert E >= len(scales), (E, scales)
    K = max(min(num_relations, math.comb(num_inputs, k)) for k in scales)
    sel = np.zeros((E, K, num_inputs), np.int64)
    fmask = np.zeros((E, K, num_inputs), np.float32)
    tmask = np.zeros((E, K), np.float32)
    for si, k in enumerate(scales):
        combos = list(itertools.combinations(range(num_inputs), k))
        for j in range(min(num_relations, len(combos))):
            sel[si, j, :k] = combos[j]
            fmask[si, j, :k] = 1.0
            tmask[si, j] = 1.0
    return {'sel': sel, 'frame_mask': fmask, 'token_mask': tmask,
            'scales': scales, 'E': E, 'K': K, 'num_inputs': num_inputs}


def mstrn_expert_params(msr, spec):
    """The per-scale relation MLPs stacked and zero-padded to one dict of
    (E, ...) tensors in the JAX package's layout: ``w1`` (E, n * d,
    bottleneck), ``b1`` (E, bottleneck), ``w2`` (E, bottleneck, out),
    ``b2`` (E, out). A torch ``Linear`` weight is (out, in), a flax kernel
    (in, out): each is transposed.

    ``msr``: a ``MultiScaleRelation`` (its parameters, so the stack is
    differentiable) or its state dict (``relations.{si}.relate.1.weight``
    ...)."""
    p = dict(msr.named_parameters()) if isinstance(msr, torch.nn.Module) \
        else msr
    E, n = spec['E'], spec['num_inputs']
    w1, b1, w2, b2 = [], [], [], []
    for si, k in enumerate(spec['scales']):
        pre = f'relations.{si}.relate.'
        w = p[pre + '1.weight'].t()                      # (k * d, bottleneck)
        w1.append(F.pad(w, (0, 0, 0, w.shape[0] // k * (n - k))))
        b1.append(p[pre + '1.bias'])
        w2.append(p[pre + '3.weight'].t())
        b2.append(p[pre + '3.bias'])
    pad = E - len(spec['scales'])
    return {name: F.pad(torch.stack(ts), (0, 0) * (ts[0].dim()) + (0, pad))
            for name, ts in (('w1', w1), ('b1', b1), ('w2', w2),
                             ('b2', b2))}


def mstrn_expert_apply(stacked, spec, feats, mesh=None,
                       expert_axis: str = 'expert'):
    """Expert-parallel ``MultiScaleRelation`` forward: ``feats`` (B, n, d)
    per-frame features -> (B, out), equal to the dense module without a
    generator. Each expert runs on its K x B padded combinations; with an
    ``expert_axis`` of the mesh each rank runs its E / n experts and the
    outputs are all-gathered. The combine is a masked sum (a padded token
    would add the MLP's response to zeros, its biases)."""
    B, n, d = feats.shape
    sel = torch.as_tensor(spec['sel'], device=feats.device)
    fmask = torch.as_tensor(spec['frame_mask'], device=feats.device,
                            dtype=feats.dtype)
    tmask = torch.as_tensor(spec['token_mask'], device=feats.device)
    E, K = tmask.shape
    g = feats.index_select(1, sel.reshape(-1))            # (B, E*K*n, d)
    g = g.reshape(B, E, K, n, d) * fmask[None, :, :, :, None]
    x = g.permute(1, 2, 0, 3, 4).reshape(E, K * B, n * d)
    ranks = axis_size(mesh, expert_axis)
    if ranks > 1:
        lo, hi = (axis_index(mesh, expert_axis) * E // ranks,
                  (axis_index(mesh, expert_axis) + 1) * E // ranks)
        group = axis_group(mesh, expert_axis)
        local = expert_sharding(mesh, stacked, expert_axis)
        y = _relations(local, replicated(x, group)[lo:hi])
        y = gather_replicated(y, group)
    else:
        y = _relations(stacked, x)
    y = y.reshape(E, K, B, -1) * tmask[:, :, None, None].to(y.dtype)
    return y.sum(dim=(0, 1))                               # (B, out)


def _relations(p, x):
    h = torch.relu(torch.einsum('etd,edh->eth', torch.relu(x),
                                p['w1'].to(x.dtype)) + p['b1'][:, None])
    return torch.einsum('eth,eho->eto', h, p['w2'].to(h.dtype)) \
        + p['b2'][:, None]


def trn_expert_forward(model, mesh=None, expert_axis: str = 'expert'):
    """A ``TRN``'s eval forward with its MSTRN head run as experts.

    Returns ``(fwd, spec)``: ``fwd(clips, stacked=None) -> logits`` equals
    ``model(clips)`` without a generator (eval: no dropout), on the model's
    own parameters. The expert count is padded up to a multiple of the
    mesh's expert axis. ``stacked`` is the precomputed
    ``mstrn_expert_params(model.temporal_relation, spec)``; without it
    every call stacks and pads the head's weights again (the padded (E,
    n * d, bottleneck) first layer, ~0.5 GB for the 8-segment resnet50
    head), so a caller that serves should compute it once."""
    if model.consensus != 'MSTRN':
        raise ValueError(f'expert-parallel head supports MSTRN, '
                         f'got {model.consensus}')
    n = model.num_segments
    ranks = axis_size(mesh, expert_axis)
    pad_to = -(-(n - 1) // ranks) * ranks if ranks > 1 else None
    spec = mstrn_expert_spec(n, model.temporal_relation.num_relations,
                             pad_experts_to=pad_to)
    base = model.base_module

    def fwd(clips, stacked=None):
        b, c, t = clips.shape[:3]
        with model._autocast(clips):
            frames = clips.transpose(1, 2).reshape(b * t, c, *clips.shape[3:])
            feats = base._logits(base._features(frames)).reshape(b, n, -1)
            if stacked is None:
                stacked = mstrn_expert_params(model.temporal_relation, spec)
            y = mstrn_expert_apply(stacked, spec, feats, mesh, expert_axis)
            return model._logits(y)

    return fwd, spec
