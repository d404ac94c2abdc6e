#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` alone, on one CUDA card
(``pretorched_tpu_torch``; no JAX):

    python3 tools/port_seq_probe.py

Fabricates phase 4's hosted ``nonlocalresnet3d50`` file and frame folder
under ``build/chip_smoke``, builds the kernels, runs phase 6's unsharded
bf16 train steps for the step time the seq step is printed beside, then
``chip_smoke.seq_path``: K1-fwd, K1-dq and K1-dkv at the stacked seq
shapes against their plain versions, 12 bf16 train steps of the model
time-sharded over 2 shards in one process, the seq step against the
unsharded step (f64; and f32 with the kernels, with its planted fault),
and the whole-batch backward against its microbatches'.
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


def main():
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

    build.load_library()
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.environ['PRETORCHED_HOME'] = str(cs.WORK / 'zoo')
    os.environ['PRETORCHED_STRICT_WEIGHTS'] = '1'
    cs.phase('4. fabricated non-local checkpoint and frames')
    cs.fabricate(pretorched, torch, np)
    cli = cs.load_cli('video_eval_torch')
    cs.phase('6. training path (the unsharded step)')
    *_, train_ms = cs.train_path(pretorched, na, torch, np, cli)
    cs.phase('22. the seq axis')
    out = cs.seq_path(pretorched, na, torch, np, cli, train_ms)
    cs.phase('done')
    print(json.dumps({'seq': out, 'card': cs.CARD}))


if __name__ == '__main__':
    try:
        main()
    except cs.SmokeFailure as e:
        print(f'port_seq_probe: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
