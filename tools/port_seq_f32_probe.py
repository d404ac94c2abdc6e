#!/usr/bin/env python3
"""Where an f32 gradient of ``nonlocalresnet3d50`` can be held to f64, on
one CUDA card (``pretorched_tpu_torch``; no JAX):

    python3 tools/port_seq_f32_probe.py

Fabricates phase 4's hosted ``nonlocalresnet3d50`` file and frame folder
under ``build/chip_smoke``, randomizes every BN as ``chip_smoke.py``'s
phase 22 does, and takes the gradient of 2 clips x 32 x 224 px once in
f64 (the attention plain, in f64) and in f32 (TF32 off) with the kernels
and with the plain attention, unsharded and time-sharded over 2 stacked
shards (``parallel.seq``), printing each against the f64 step (each
parameter's rel L2 as ``chip_smoke.grad_spread``, worst three and median;
all gradients together): A, the weights as they are with eval BN and a
loss linear in the logits; A2, the same with train-mode BN; B-D, each
non-local block's theta divided by its attention logits' spread, with
eval BN and the linear loss (B, phase 22's f32 check), train-mode BN and
the linear loss (C) and the cross-entropy (D), each also with the halos'
gradients dropped (the planted fault). Exits nonzero without CUDA.
"""
import copy
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    cs.check(torch.cuda.is_available(), 'torch.cuda.is_available() is false')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    cs.CARD = smi.stdout.strip().splitlines()[0]
    print(cs.CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.models import nonlocalnet
    from pretorched_tpu_torch.ops.cuda import build
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    from pretorched_tpu_torch.parallel import seq as seq_rules
    from pretorched_tpu_torch.parallel.seq import seq_parallel
    from pretorched_tpu_torch.parallel.train import cross_entropy

    build.load_library()
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.environ['PRETORCHED_HOME'] = str(cs.WORK / 'zoo')
    os.environ['PRETORCHED_STRICT_WEIGHTS'] = '1'
    cs.fabricate(pretorched, torch, np)
    cli = cs.load_cli('video_eval_torch')
    base = pretorched.nonlocalresnet3d50(num_classes=400,
                                         pretrained='kinetics-400')
    cs.randomize_bn(base, torch, seed=22)
    base.cuda()
    x, labels = cs.train_batch(cli, base.settings, torch)
    x2, l2 = x[:2], labels[:2]
    g = torch.Generator(device='cuda').manual_seed(22)
    w2 = torch.randn(2, 400, device='cuda', generator=g)
    attention = nonlocalnet.auto_nonlocal_attention
    stacked_halo = seq_rules._Stacked.halo

    def halo_without_grad(self, x, left, right, value):
        out = stacked_halo(self, x.detach(), left, right, value)
        n = x.shape[2]
        return torch.cat([out[:, :, :left], x, out[:, :, left + n:]], dim=2)

    def run(b, shards, dtype, train, ce, attn=None, fault=False):
        m = copy.deepcopy(b).to(dtype).train(train)
        if shards:
            seq_parallel(m, shards=shards)
        nonlocalnet.auto_nonlocal_attention = attn or (
            cs.attention_f64 if dtype == torch.float64 else attention)
        if fault:
            seq_rules._Stacked.halo = halo_without_grad
        try:
            logits = m(x2.to(dtype))
            loss = (cross_entropy(logits, l2) if ce else
                    (logits * w2.to(dtype)).sum() / w2.numel())
            loss.backward()
        finally:
            nonlocalnet.auto_nonlocal_attention = attention
            seq_rules._Stacked.halo = stacked_halo
        return loss.item(), {n: p.grad.double()
                             for n, p in m.named_parameters()}

    def report(what, got, want):
        (lg, gg), (lw, gw) = got, want
        e = cs.grad_spread(gg, gw)
        o = sorted(e, key=e.get, reverse=True)
        tog = (sum((gg[n] - gw[n]).norm().item() ** 2 for n in gw)
               / sum(v.norm().item() ** 2 for v in gw.values())) ** 0.5
        print(f'  {what}: loss rel {abs(lg - lw) / abs(lw):.2e}; worst '
              + ', '.join(f'{n} {e[n]:.2e}' for n in o[:3])
              + f'; median {e[o[len(o) // 2]]:.2e}; together {tog:.2e}',
              flush=True)
        return e

    def logit_spread(b, train):
        """Per block, the std of its attention logits (f64 forward)."""
        stds = []

        def record(q, k, v, *a):
            s = torch.bmm(q[:, :256], k.transpose(1, 2))
            stds.append(s.std().item())
            return cs.attention_f64(q, k, v, *a)

        m = copy.deepcopy(b).double().train(train)
        nonlocalnet.auto_nonlocal_attention = record
        try:
            with torch.no_grad():
                m(x2.double())
        finally:
            nonlocalnet.auto_nonlocal_attention = attention
        return stds

    def tempered(b, train, target=1.0):
        stds = logit_spread(b, train)
        t = copy.deepcopy(b)
        blocks = [m for m in t.modules()
                  if isinstance(m, nonlocalnet.NonLocalBlock)]
        with torch.no_grad():
            for blk, s in zip(blocks, stds):
                blk.theta.weight.mul_(target / s)
                blk.theta.bias.mul_(target / s)
        print(f'  logit std per block {[f"{s:.3g}" for s in stds]} -> after '
              f'{[f"{s:.3g}" for s in logit_spread(t, train)]}', flush=True)
        return t

    f32, f64 = torch.float32, torch.float64
    print('A. as is, eval BN, linear loss', flush=True)
    print(f'  logit std per block {logit_spread(base, False)}', flush=True)
    want = run(base, None, f64, False, False)
    report('unsharded f32 kernels', run(base, None, f32, False, False), want)
    report('unsharded f32 plain attention',
           run(base, None, f32, False, False,
               attn=na.nonlocal_attention_reference), want)
    report('seq f32 kernels', run(base, 2, f32, False, False), want)
    print('A2. as is, train BN, linear loss', flush=True)
    want = run(base, None, f64, True, False)
    report('unsharded f32 kernels', run(base, None, f32, True, False), want)
    report('unsharded f32 plain attention',
           run(base, None, f32, True, False,
               attn=na.nonlocal_attention_reference), want)
    for name, train, ce in (('B. tempered, eval BN, linear', False, False),
                            ('C. tempered, train BN, linear', True, False),
                            ('D. tempered, train BN, cross-entropy', True,
                             True)):
        print(name, flush=True)
        t = tempered(base, train)
        want = run(t, None, f64, train, ce)
        report('seq f64', run(t, 2, f64, train, ce), want)
        report('unsharded f32 kernels', run(t, None, f32, train, ce), want)
        report('unsharded f32 plain attention',
               run(t, None, f32, train, ce,
                   attn=na.nonlocal_attention_reference), want)
        report('seq f32 kernels', run(t, 2, f32, train, ce), want)
        report('seq f32 kernels, halo gradients dropped',
               run(t, 2, f32, train, ce, fault=True), want)
        del t, want
        torch.cuda.empty_cache()


if __name__ == '__main__':
    try:
        main()
    except cs.SmokeFailure as e:
        print(f'port_seq_f32_probe: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
