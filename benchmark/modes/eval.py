"""Multi-clip video evaluation: the device half of the video eval CLI.

Set-up makes a pool of raw uint8 videos and their labels on the device
from the seed, the model from its configuration with seeded weights, and
``parallel.evaluate.multi_clip_eval_step``. A step takes the next
``videos_per_step`` videos of a seeded order of the pool (every seed runs
the same pairs of videos' sizes, in another order), cuts each into
``clips_per_video`` clips of the configuration's frames at the CLI's clip
starts, runs ``transforms.fused.preprocess_clip`` once a clip and
``torch.cat`` per video as the CLI's ``load_video`` does, stacks the
videos as its ``eval_batches`` does, and runs the eval step; the metric
sums stay on the device. At most ``queued_steps`` steps are in flight.

What the window produced is kept for the check: every step's logits (a
forward hook on the model) and metric sums, and the preprocessed clips of
the first step of each group of videos. The check runs the plain
reference once on each group that the window ran and compares every step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import common
from benchmark.reference import preprocess as ref_preprocess
from benchmark.reference.ops import Ops, float32_matmuls


def inputs(run):
    """The pool of videos and labels, the groups a step takes, the clip
    starts: all from the seed."""
    cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
    pool, per_step = mix['pool_videos'], mix['videos_per_step']
    g = torch.Generator(dev).manual_seed(run.seeds['data'])
    videos = torch.randint(0, 256, (pool, mix['video_frames'],
                                    mix['frame_height'], mix['frame_width'],
                                    3), generator=g, device=dev,
                           dtype=torch.uint8)
    labels = torch.randint(0, cfg['architecture']['num_classes'], (pool,),
                           generator=g, device=dev)
    order = torch.randperm(pool, generator=torch.Generator().manual_seed(
        run.seeds['order'])).tolist()
    groups = [order[i:i + per_step] for i in range(0, pool, per_step)]
    # the eval CLI's clip starts (``sample_clips``)
    frames = cfg['clip']['frames']
    starts = np.linspace(0, max(mix['video_frames'] - frames, 0),
                         mix['clips_per_video']).astype(int).tolist()
    return dict(videos=videos, labels=labels, groups=groups, starts=starts)


def measure(run):
    from pretorched_tpu_torch.parallel.evaluate import multi_clip_eval_step
    from pretorched_tpu_torch.transforms.fused import preprocess_clip

    cfg, mix = run.cell.config, run.cell.traffic
    frames, settings = cfg['clip']['frames'], cfg['preprocess']
    dtype = getattr(torch, run.cell.dtype)
    ev = inputs(run)
    videos, groups = ev['videos'], ev['groups']
    group_labels = [ev['labels'][g] for g in groups]

    model, ev['state'] = common.build_model(run)
    model.eval()
    if dtype == torch.bfloat16:
        model.bfloat16()
    step = multi_clip_eval_step(model)
    run.patch_spans()
    logits = []

    def keep_logits(module, args, out):
        if run.in_window:
            logits.append(out.detach().clone())

    hook = model.register_forward_hook(keep_logits)

    def one_step(i):
        g = i % len(groups)
        with run.spans.span('preprocess'):
            x = torch.stack([
                torch.cat([preprocess_clip(videos[v, s:s + frames], settings,
                                           channels_last=False, dtype=dtype)
                           for s in ev['starts']])
                for v in groups[g]])
        with run.spans.span('forward'):
            out = step(x, group_labels[g])
        return g, x, out

    for i in range(mix['warmup_steps']):
        one_step(i)
    run.setup_done()
    sums, ran, kept = [], [], {}

    def window_step(i):
        g, x, out = one_step(i)
        if run.in_window:
            sums.append(out)
            ran.append(g)
            kept.setdefault(g, x)

    run.window(window_step, mix['videos_per_step'] * mix['clips_per_video'])
    hook.remove()
    ev.update(logits=logits, sums=sums, ran=ran, kept=kept)
    return ev


def reference(run, ev, group, ops=None):
    """(clips (N, 3, T, S, S), logits (N, classes)) of the plain reference
    on one group of videos, the model in blocks of clips."""
    cfg = run.cell.config
    frames = cfg['clip']['frames']
    ops = ops or Ops()
    x = torch.stack([ref_preprocess.clip(ev['videos'][v, s:s + frames],
                                         cfg['preprocess'], ops.q)
                     for v in ev['groups'][group] for s in ev['starts']])
    block = run.cell.traffic['reference_clips']
    with torch.no_grad(), float32_matmuls(run.reference_tf32):
        logits = torch.cat([run.cell.reference.forward(
            ev['state'], cfg, x[i:i + block], ops=ops)
            for i in range(0, len(x), block)])
    return x, logits


def consensus(logits, labels, clips, q=None):
    """The protocol's loss sum of one step from its (videos * clips,
    classes) logits: the softmax averaged over each video's clips, the NLL
    of the average at the label; ``q`` rounds each stage (a control's
    precision). (Its top-1 and top-5 counts are not compared: with seeded
    weights and labels they read 0 on both sides.)"""
    q = q or (lambda t: t)
    probs = q(q(F.softmax(logits.float().reshape(len(labels), clips, -1),
                          dim=-1)).mean(dim=1))
    logp = q(torch.log(probs.clamp(min=1e-30)))
    return {'loss': -logp.gather(1, labels[:, None])[:, 0].sum().item()}


def _compare(run, ev, produced, want):
    """Readings of ``produced`` [(group, clips or None, logits, sums)]
    against ``want`` {group: (clips, logits)}: (numbers, failed). The
    clips and logits are held to the reference's; the step's sums to the
    protocol's sums of the step's own logits, so that the logits' rounding
    is judged once, by ``logits_rel_l2``."""
    clips = run.cell.traffic['clips_per_video']
    out = {'clips_rel_l2': 0.0, 'logits_rel_l2': 0.0,
           'consensus_loss_rel': 0.0}
    failed = 0
    for group, x, logits, sums in produced:
        ref_x, ref_logits = want[group]
        logits = logits.float()
        if not bool(torch.isfinite(logits).all()) or logits.shape != \
                ref_logits.shape:
            failed += len(ref_logits)
            continue
        if x is not None:
            x = x.reshape(ref_x.shape).float()
            out['clips_rel_l2'] = max(out['clips_rel_l2'], (
                (x - ref_x).flatten(1).norm(dim=1)
                / ref_x.flatten(1).norm(dim=1)).max().item())
        out['logits_rel_l2'] = max(out['logits_rel_l2'], (
            (logits - ref_logits).norm(dim=1)
            / ref_logits.norm(dim=1)).max().item())
        expect = consensus(logits, ev['labels'][ev['groups'][group]],
                           clips)
        out['consensus_loss_rel'] = max(out['consensus_loss_rel'], abs(
            float(sums['loss']) - expect['loss']) / abs(expect['loss']))
    return out, failed


def readings(run, ev):
    if len(ev['logits']) != len(ev['ran']):     # a forward per step, no more
        return {k: math.nan for k in run.cell.limits}, run.samples
    want = {g: reference(run, ev, g) for g in sorted(set(ev['ran']))}
    first = {}
    for i, g in enumerate(ev['ran']):
        first.setdefault(g, i)
    produced = [(g, ev['kept'][g] if first[g] == i else None,
                 ev['logits'][i], ev['sums'][i])
                for i, g in enumerate(ev['ran'])]
    return _compare(run, ev, produced, want)


def control(run, ev):
    """The reference in the program's place, in the precision below the
    traffic's (``Run.lower_precision``), on each group once."""
    want, produced = {}, []
    clips = run.cell.traffic['clips_per_video']
    for g in range(len(ev['groups'])):
        want[g] = reference(run, ev, g)
        with run.lower_precision() as ops:
            x, logits = reference(run, ev, g, ops=ops)
            sums = consensus(logits, ev['labels'][ev['groups'][g]], clips,
                             ops.q)
        produced.append((g, x, logits, sums))
    return _compare(run, ev, produced, want)
