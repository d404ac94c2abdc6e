#!/usr/bin/env python3
"""Run programs saved by ``zoo.export.export_model`` in a process that
builds no model, on one CUDA card (no JAX):

    python3 tools/port_export_reload.py SPEC.json

``SPEC.json`` holds ``{"programs": [{"name", "path", "shape", "dtype",
"batches", "seed"}], "out": DIR}``. For each program and batch B the input
is ``seeded_input(shape, B, dtype, seed)`` (the caller builds the same one
for its eager forward); the reloaded program's output goes to
``DIR/<name>-B<B>.npy`` (f32). For each call the tool reads the kernels'
launch counts (K1-fwd by program, K2 by kernel) and times 5 more calls by
CUDA events (median). TF32 is off. It prints one line ``RELOAD {json}``
and exits nonzero without CUDA.

The process imports ``pretorched_tpu_torch.zoo.export`` (which registers
the operators ``pretorched::nonlocal_attention_fwd`` and
``pretorched::fused_bottleneck_tail``) and constructs no model: the
programs hold the kernels as operators.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def seeded_input(shape, batch, dtype, seed):
    """(batch,) + shape standard normal values on the card, drawn from a
    CUDA generator seeded with ``seed + batch``, in ``dtype``."""
    g = torch.Generator(device='cuda').manual_seed(seed + batch)
    return torch.randn((batch,) + tuple(shape), device='cuda',
                       generator=g).to(getattr(torch, dtype))


def _counts(na, fb_cuda):
    return {'fwd': dict(na.nonlocal_attention_cuda.by_kernel),
            'k2': dict(fb_cuda.fused_bottleneck_tail_cuda.by_kernel)}


def _delta(after, before):
    return {op: {k: after[op][k] - before[op][k] for k in after[op]
                 if after[op][k] != before[op][k]} for op in after}


def main(spec_path):
    if not torch.cuda.is_available():
        print('port_export_reload: no CUDA card', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    from pretorched_tpu_torch.zoo.export import load_exported

    with open(spec_path) as f:
        spec = json.load(f)
    results = {}
    for prog in spec['programs']:
        call, params = load_exported(prog['path'])
        for b in prog['batches']:
            x = seeded_input(prog['shape'], b, prog['dtype'], prog['seed'])
            before = _counts(na, fb_cuda)
            out = call(params, x)
            torch.cuda.synchronize()
            launched = _delta(_counts(na, fb_cuda), before)
            np.save(os.path.join(spec['out'], f"{prog['name']}-B{b}.npy"),
                    out.float().cpu().numpy())
            times = []
            for _ in range(5):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                call(params, x)
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            results[f"{prog['name']}-B{b}"] = {
                'launches': launched, 'ms': sorted(times)[2],
                'ms_all': times}
            del x, out
        del call, params
        torch.cuda.empty_cache()
    print('RELOAD ' + json.dumps(results), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1]))
