#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` alone, on one CUDA card
(``pretorched_tpu_torch``; no JAX):

    python3 tools/port_export_probe.py

Fabricates phase 4's hosted ``nonlocalresnet3d50`` file and frame folder
and phase 14's hosted files and JPEGs under ``build/chip_smoke``, then runs
``chip_smoke.export_mesh_path``: the exported programs of
``nonlocalresnet3d50`` (bf16 at batch 20, f32 with a symbolic batch),
``slowfast_resnet50(fused_blocks=32)`` and ``resnet50`` (symbolic batch)
reloaded in a fresh process and held to the eager forwards, the
golden-accuracy tool, and the mesh at world size 1 (the ImageNet CLI with
``--zero`` and ``--zero fsdp``, ZeRO train steps of the non-local model).
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
    from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    build.load_library()
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.environ['PRETORCHED_HOME'] = str(cs.WORK / 'zoo')
    os.environ['PRETORCHED_STRICT_WEIGHTS'] = '1'
    cs.phase('4. fabricated non-local checkpoint and frames')
    cs.fabricate(pretorched, torch, np)
    cs.phase('14. fabricated hosted files and JPEGs')
    cs.fabricate_imagenet(pretorched, torch, np)
    cs.phase('20. export, golden tool, mesh')
    out = cs.export_mesh_path(pretorched, torch, np, na, fb_cuda,
                              cs.load_cli('video_eval_torch'))
    cs.phase('done')
    print(json.dumps({'export_mesh': out, 'card': cs.CARD}))


if __name__ == '__main__':
    try:
        main()
    except cs.SmokeFailure as e:
        print(f'port_export_probe: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
