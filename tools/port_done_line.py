#!/usr/bin/env python3
"""K1's done line alone, on one CUDA card (``pretorched_tpu_torch``; no JAX):

    python3 tools/port_done_line.py [CHECKOUT]

Builds the kernels of CHECKOUT (a directory that holds
``pretorched_tpu_torch``; default: this repository), for instance a parent
commit unpacked with ``git archive`` into a git-ignored directory, and
runs ``chip_smoke.k1_done_line`` on them: K1-fwd, K1-dq and K1-dkv in bf16
at N = Nk = 65,536, C = Cv = 256 against the plain version computed in
chunks of queries, each timed beside SDPA, then the f32 kernels timed at
the train shapes of layers 2 and 3 beside SDPA in f32. Prints the numbers
as one JSON line; exits nonzero without CUDA or on a disagreement.
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
    sys.path.insert(0, str(checkout))
    # this repository's chip_smoke.py, whichever checkout's kernels run
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    cs.check(torch.cuda.is_available(), 'torch.cuda.is_available() is false')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    cs.CARD = smi.stdout.strip().splitlines()[0]
    print(cs.CARD, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pretorched_tpu_torch.ops.cuda import build
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    cs.check(Path(na.__file__).resolve().is_relative_to(checkout),
             f'{na.__file__} is not under {checkout}')
    build.load_library()
    print(f'kernels of {checkout}: {build.library_path()}', flush=True)
    cs.phase("5. K1's done line")
    out = cs.k1_done_line(na, torch)
    cs.phase('done')
    print(json.dumps({'k1_done_line': out, 'checkout': str(checkout),
                      'card': cs.CARD}))


if __name__ == '__main__':
    main()
