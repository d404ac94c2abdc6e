#!/usr/bin/env python3
"""K1-fwd in bf16 at the shapes of its narrow and wide wgmma programs, on
one CUDA card (``pretorched_tpu_torch``; no JAX), on a given checkout's
kernels:

    python3 tools/port_narrow_probe.py [CHECKOUT [LABEL]]

CHECKOUT is a directory that holds ``pretorched_tpu_torch`` (default: this
repository), for instance a variant unpacked into a git-ignored directory;
run two checkouts in turns (A, B, B, A) in one call to compare them on one
card. At SAGAN's three shapes, MNISTNonLocalNet's two and the video
slice's (``chip_smoke.py``'s tables) it holds the wrapper's launch to the
plain version at phase 3's tolerances and prints the CUDA-event median of
20 calls and the device time of 20 calls queued behind a sleep kernel
(``chip_smoke.queued_ms``: no host time in it), with ptxas's notes on
K1-fwd's kernels. One JSON line at the end;
exits nonzero without CUDA or on a disagreement.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main():
    checkout = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO
    label = sys.argv[2] if len(sys.argv) > 2 else checkout.name
    sys.path.insert(0, str(checkout))
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    cs.check(torch.cuda.is_available(), 'torch.cuda.is_available() is false')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    from pretorched_tpu_torch.ops.cuda import build
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    cs.check(Path(na.__file__).resolve().is_relative_to(checkout),
             f'{na.__file__} is not under {checkout}')
    build.load_library()
    print(f'{label}: {card}, kernels of {checkout}', flush=True)
    for line in build.build_log.splitlines():
        if 'nonlocal_attention_fwd' in line and (
                'Function properties' in line
                or 'Potential Performance Loss' in line):
            print('  ' + cs.kernel_label(line)
                  + (' [C7511/C7520]' if 'Performance Loss' in line else ''))
    shapes = {**cs.BIGGAN_SHAPES,
              **{f'mnist {i + 1}': s for i, s in enumerate(cs.MNIST_SHAPES)},
              **{k: cs.SLICE_SHAPES[k] for k in ('layer2', 'cv_ne_c',
                                                  'ragged_n')}}
    g = torch.Generator(device='cuda').manual_seed(5)
    rows = {}
    for name, (b, n, nk, c, cv) in shapes.items():
        dt = torch.bfloat16
        q = (torch.randn(b, n, c, device='cuda', generator=g)
             / c ** 0.25).to(dt)
        k = (torch.randn(b, nk, c, device='cuda', generator=g)
             / c ** 0.25).to(dt)
        v = torch.randn(b, nk, cv, device='cuda', generator=g).to(dt)
        program = na._program(na.attention_kernel(dt, c, cv, 'fwd'), c, cv)
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        want, want_lse = na.nonlocal_attention_fwd_lse_reference(
            q.float(), k.float(), v.float())
        err, rel, err_lse = cs.fwd_errors(out, lse, want, want_lse)
        del out, lse, want, want_lse
        tol, tol_lse = cs.TOL['bfloat16']
        cs.check(err <= tol and rel <= cs.TOL_REL_BF16 and err_lse <= tol_lse,
                 f'{name}: K1-fwd disagrees with the plain version: '
                 f'{err}, {rel}, {err_lse}')
        call = lambda: na.nonlocal_attention_cuda(q, k, v)  # noqa: E731
        ms = cs.median_ms(call)
        device_ms = cs.queued_ms(call, torch)
        bound_ms, _ = cs.attention_bounds(b, n, nk, c, cv, 'bfloat16')['fwd']
        print(f'{name:18s} {(b, n, nk, c, cv)} [{program}]: events '
              f'{ms:.4f} ms, queued {device_ms:.4f} ms, bound '
              f'{bound_ms:.4f} ms; /max|plain| {rel:.2e}', flush=True)
        rows[name] = {'shape': [b, n, nk, c, cv], 'program': program,
                      'ms': ms, 'device_ms': device_ms, 'bound_ms': bound_ms,
                      'max_rel_err': rel}
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({'label': label, 'card': card, 'rows': rows}))


if __name__ == '__main__':
    main()
