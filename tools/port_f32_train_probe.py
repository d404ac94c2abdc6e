#!/usr/bin/env python3
"""The f32 backward's phases of ``chip_smoke.py`` alone, on one CUDA card
(``pretorched_tpu_torch``; no JAX):

    python3 tools/port_f32_train_probe.py [bwd] [train] [grad] [seq]

Builds the kernels and fabricates phase 4's hosted ``nonlocalresnet3d50``
file and frame folder under ``build/chip_smoke``, then runs (all by
default):

* ``bwd``: phase 5 (``chip_smoke.backward_vs_plain``: K1-dq and K1-dkv at
  every train shape in both dtypes, the f32 rows on tf32_wgmma beside the
  tf32x3 and scalar programs at layers 2 and 3) and the done line
  (``k1_done_line``, its f32 block);
* ``train``: phase 6b (``train_f32_path``: the f32 fine-tuning step on
  tf32_wgmma, with K1-fwd on tf32x3, on tf32x3 and on the scalar programs
  in turns, profiled);
* ``grad``: phase 7 (``gradient_agreement``: the f32 step with the kernels
  and with the plain attention against the f64 step);
* ``seq``: phase 22 (``seq_path``, whose f32 step runs tf32_wgmma), after
  phase 6's bf16 steps for its unsharded step time.

Prints its numbers as one JSON line; exits nonzero without CUDA or when a
check fails.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

PARTS = ('bwd', 'train', 'grad', 'seq')


def main(argv):
    parts = argv or PARTS
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise SystemExit(f'port_f32_train_probe: unknown parts {unknown}')
    cs.phase('1. card')
    cs.check(torch.cuda.is_available(), 'torch.cuda.is_available() is false')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    cs.CARD = smi.stdout.strip().splitlines()[0]
    print(cs.CARD, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.ops.cuda import build
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    cs.phase('2. build')
    build.load_library()
    for line in build.build_log.splitlines():
        if 'Function properties for' in line and 'tf32' in line:
            print('  ' + cs.kernel_label(line))
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.environ['PRETORCHED_HOME'] = str(cs.WORK / 'zoo')
    os.environ['PRETORCHED_STRICT_WEIGHTS'] = '1'
    cs.phase('4. fabricated non-local checkpoint and frames')
    cs.fabricate(pretorched, torch, np)
    cli = cs.load_cli('video_eval_torch')
    out = {'card': cs.CARD}
    if 'bwd' in parts:
        cs.phase('5. the backward kernels against the plain backward; the '
                 'done line')
        out['bwd'] = {k: v for k, v in cs.backward_vs_plain(na, torch).items()
                      if k.endswith('float32')}
        out['done_line_f32'] = cs.k1_done_line(na, torch)['float32']
    if 'train' in parts:
        cs.phase('6b. the f32 fine-tuning step')
        out['train_f32'] = cs.train_f32_path(pretorched, na, torch, np, cli)
    if 'grad' in parts:
        cs.phase('7. gradient agreement')
        cs.gradient_agreement(pretorched, na, torch, cli)
    if 'seq' in parts:
        cs.phase('6. training path (the unsharded step)')
        *_, train_ms = cs.train_path(pretorched, na, torch, np, cli)
        cs.phase('22. the seq axis')
        out['seq_f32'] = cs.seq_path(pretorched, na, torch, np, cli,
                                     train_ms)['f32']
    cs.phase('done')
    print(json.dumps(out))


if __name__ == '__main__':
    try:
        main(sys.argv[1:])
    except cs.SmokeFailure as e:
        print(f'port_f32_train_probe: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
