"""Fine-tuning: ``parallel.train.make_train_step`` with SGD and step decay.

Set-up makes a pool of ``pool_batches`` normalized batches of
``clips_per_step`` clips and their labels on the device from the seed,
the model with seeded weights (in the traffic's precision: bfloat16 is the
port's autocast, float32 runs with TF32 as the traffic sets it),
``sgd_step_decay`` and the step with ``remat``. The same step object
takes its first ``checked_steps`` steps on the pool's first batches (rows
that all differ) in set-up, which warms every shape up; the window goes
on with it through the pool, cycled, at most ``queued_steps`` steps in
flight.

What is kept for the check: the loss of each checked step; the norm of
each parameter's first gradient as the optimizer got it, worked out from
its momentum after one step (SGD's first momentum is the gradient plus
the weight decay); the norm of each parameter's change after the checked
steps; every window step's loss, for the count of non-finite steps. The
reference takes the same seeded weights and batches through the same
number of steps.
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F

from benchmark.harness import common
from benchmark.reference.ops import Ops, float32_matmuls


def inputs(run):
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    g = torch.Generator(dev).manual_seed(run.seeds['data'])
    n, frames, crop = (mix['clips_per_step'], cfg['clip']['frames'],
                       cfg['clip']['crop'])
    batches = torch.randn((mix['pool_batches'], n, 3, frames, crop, crop),
                          generator=g, device=dev,
                          dtype=torch.float64 if run.cell.dtype == 'float64'
                          else torch.float32)
    labels = torch.randint(0, cfg['architecture']['num_classes'],
                           (mix['pool_batches'], n), generator=g, device=dev)
    return dict(batches=batches, labels=labels)


def _norms(tensors):
    return torch.stack(torch._foreach_norm(tensors)).tolist()


def measure(run):
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay)

    mix = run.cell.traffic
    ev = inputs(run)
    batches, labels = ev['batches'], ev['labels']
    model, state = common.build_model(run)
    if run.cell.dtype == 'bfloat16':
        model.bfloat16()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt, sched = sgd_step_decay(params, lr=mix['lr'],
                                momentum=mix['momentum'],
                                weight_decay=mix['weight_decay'])
    step = make_train_step(model, opt, sched, remat=tuple(mix['remat']))
    run.patch_spans()
    pool = len(batches)
    losses = []
    for i in range(mix['checked_steps']):
        losses.append(step(batches[i], labels[i])['loss'].item())
        if i == 0:
            # an optimizer that kept no momentum got no gradient to read
            first = [opt.state[p].get('momentum_buffer',
                                      torch.full_like(p, math.nan))
                     - mix['weight_decay'] * state[n]
                     for n, p in zip(names, params)]
            ev['grad_norms'] = _norms(first)
            del first
    ev['change_norms'] = _norms([p.detach() - state[n]
                                 for n, p in zip(names, params)])
    run.setup_done()
    window_losses = []

    def window_step(i):
        b = (mix['checked_steps'] + i) % pool
        with run.spans.host('step'):
            out = step(batches[b], labels[b])
        if run.in_window:
            window_losses.append(out['loss'])

    run.window(window_step, mix['clips_per_step'])
    ev.update(state=state, names=names, losses=losses,
              window_losses=window_losses)
    return ev


def reference(run, ev, ops=None, feed=None):
    """The plain reference's checked steps from the same weights and
    batches: (losses, first gradients' norms, changes' norms). ``feed``
    (x, labels) -> (x, labels) plants a fault in what a step takes."""
    mix, cfg = run.cell.traffic, run.cell.config
    ops = ops or Ops()
    state = ev['state']
    params = {n: state[n].detach().clone().requires_grad_()
              for n in ev['names']}
    start = {n: state[n] for n in ev['names']}
    buffers = {k: v for k, v in state.items() if k not in params}
    momentum, losses = {}, []
    with float32_matmuls(run.reference_tf32):
        for i in range(mix['checked_steps']):
            x, labels = ev['batches'][i], ev['labels'][i]
            if feed is not None:
                x, labels = feed(x, labels)
            logits = run.cell.reference.forward({**params, **buffers}, cfg,
                                                x, train=True, ops=ops)
            loss = F.cross_entropy(logits.float(), labels)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(loss.item())
            if i == 0:
                grad_norms = _norms(list(grads))
            # SGD with momentum, weight decay before the momentum trace, the
            # step decay's 0.1x every 30 steps
            lr = mix['lr'] * 0.1 ** (i // 30)
            with torch.no_grad():
                for (n, p), g in zip(params.items(), grads):
                    d = g + mix['weight_decay'] * p
                    momentum[n] = (d if i == 0
                                   else momentum[n] * mix['momentum'] + d)
                    p -= lr * momentum[n]
            del grads, logits, loss
    change_norms = _norms([params[n].detach() - start[n] for n in params])
    return losses, grad_norms, change_norms


def _leaf_gaps(run, what, names, got, want, keep):
    """(widest, median) over the leaves of the gap of a leaf's norm, over
    the larger of the reference's norm of that leaf and of the median
    leaf."""
    median = statistics.median(want)
    gaps = sorted(((abs(a - b) / max(b, median), n, a, b)
                   for n, a, b, k in zip(names, got, want, keep) if k),
                  reverse=True)
    run.note(f'{what}: widest gaps (gap, leaf, program, reference; median '
             f'leaf {median:.6g}): ' + '; '.join(
                 f'{g:.4g} {n} {a:.6g} {b:.6g}' for g, n, a, b in gaps[:3]))
    return gaps[0][0], statistics.median(g for g, *_ in gaps)


def _compare(run, ev, got, want):
    losses, grads, changes = got
    ref_losses, ref_grads, ref_changes = want
    median = statistics.median(ref_grads)
    # a leaf whose gradient is nought to rounding (a bias under batch norm
    # or a key's under softmax) moves by the weight decay and round-off
    # alone: left out of the change
    moved = [g >= 1e-3 * median for g in ref_grads]
    run.note(f'losses of the checked steps: {losses} (reference '
             f'{ref_losses})')
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad = _leaf_gaps(run, 'first gradient', ev['names'], grads, ref_grads,
                      [True] * len(grads))
    change = _leaf_gaps(run, 'change', ev['names'], changes, ref_changes,
                        moved)
    return {'loss_rel_first': loss[0], 'loss_rel': max(loss),
            'grad_norm_gap': grad[0], 'grad_norm_gap_median': grad[1],
            'change_norm_gap': change[0], 'change_norm_gap_median': change[1]}


def readings(run, ev):
    failed = sum(int(not torch.isfinite(l)) for l in ev['window_losses'])
    got = (ev['losses'], ev['grad_norms'], ev['change_norms'])
    if not all(torch.isfinite(torch.tensor(ev['losses']))):
        failed += 1
    return _compare(run, ev, got, reference(run, ev)), (
        failed * run.cell.traffic['clips_per_step'])


# faults of a training step, planted in the reference put in the program's
# place (a step that leaves the state unchanged reads 1 on every change and
# needs no run)
FAULTS = {
    # half of the batch left out, the mean taken over the rest
    'half_batch': lambda x, labels: (x[:len(x) // 2], labels[:len(x) // 2]),
    # an answer altered where it is produced: each clip scored against the
    # next clip's label
    'altered_label': lambda x, labels: (x, labels.roll(1)),
}


def control(run, ev, fault=None):
    """The reference in the program's place, in the precision below the
    traffic's (``Run.lower_precision``), or in float32 with ``fault``
    planted."""
    if fault is not None:
        got = reference(run, ev, feed=FAULTS[fault])
    else:
        with run.lower_precision() as ops:
            got = reference(run, ev, ops=ops)
    return _compare(run, ev, got, reference(run, ev)), 0
