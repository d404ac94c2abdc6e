#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone, on one CUDA card
(``pretorched_tpu_torch``; no JAX):

    python3 tools/port_video_audio_probe.py

Runs ``chip_smoke.video_audio_path`` in a fresh ``build/chip_smoke``: the
eight DenseNet3D and MultiView ResNet factories on 32 clips x 16 frames x
112 px and ``soundnet8`` and ``BranchedSoundNet`` on seeded WAVs, one
bf16 forward each held to its f32 forward and timed by CUDA events, each
family's card f32 against the CPU's, the stem mixer zeroed, the VOC2007
CLI on a fabricated folder and a hosted ``resnet50``, and
``examples/visu_arch_torch.py``. Prints its numbers as one JSON line;
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
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    shutil.rmtree(cs.WORK, ignore_errors=True)
    (cs.WORK / 'zoo' / 'weights').mkdir(parents=True)
    os.environ['PRETORCHED_HOME'] = str(cs.WORK / 'zoo')
    os.environ['PRETORCHED_STRICT_WEIGHTS'] = '1'
    cs.phase('19. the video and audio families and VOC transfer')
    out = cs.video_audio_path(pretorched, torch, np, na, fb_cuda)
    cs.phase('done')
    print(json.dumps({'video_audio': out, 'card': cs.CARD}))


if __name__ == '__main__':
    try:
        main()
    except cs.SmokeFailure as e:
        print(f'port_video_audio_probe: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
