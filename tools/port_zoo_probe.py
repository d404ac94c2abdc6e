#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone, on one CUDA card
(``pretorched_tpu_torch``; no JAX):

    python3 tools/port_zoo_probe.py

Fabricates phase 14's hosted files and JPEGs under ``build/chip_smoke``,
then runs ``chip_smoke.zoo_path``: the 16 factories of the rest of the 2D
zoo, one bf16 forward each held to its f32 forward and timed by CUDA
events, ``inceptionv4`` and ``dpn92`` profiled by family, the eval CLI on
a 1001-class hosted ``inceptionv4``, one CLI train step of ``dpn68b`` and
``wideresnet50`` from an ``.npz``. Prints its numbers as one JSON line;
exits nonzero without CUDA or when a check fails.
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
    from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    shutil.rmtree(cs.WORK, ignore_errors=True)
    (cs.WORK / 'zoo' / 'weights').mkdir(parents=True)
    os.environ['PRETORCHED_HOME'] = str(cs.WORK / 'zoo')
    cs.phase('14. fabricated hosted files and JPEGs')
    cs.fabricate_imagenet(pretorched, torch, np)
    cs.phase('18. the rest of the 2D zoo')
    out = cs.zoo_path(pretorched, torch, np, na, fb_cuda)
    cs.phase('done')
    print(json.dumps({'zoo': out, 'card': cs.CARD}))


if __name__ == '__main__':
    try:
        main()
    except cs.SmokeFailure as e:
        print(f'port_zoo_probe: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
