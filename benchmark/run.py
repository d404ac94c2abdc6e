#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. The run makes
its inputs and weights from ``--seed``, warms up (set-up), measures for
``--seconds`` seconds, checks what the window produced against the plain
reference, and prints as the last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``, each
number of the check beside its limit (also the last lines of standard
error).

It exits with another code than 0, printing no result, without a CUDA
card (or with fewer than the cell asks for), without the program
``pretorched_tpu_torch`` of this checkout, or when a JAX module was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
CACHE = ROOT / 'build' / 'benchmark-cache'
os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
os.environ['CUDA_CACHE_PATH'] = str(CACHE / 'cuda')
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, str(ROOT))


def fail(message, code=2):
    print(message, file=sys.stderr, flush=True)
    sys.exit(code)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: the benchmark runs on the card only')
    from benchmark.harness import runner
    from benchmark.harness.cells import Cell
    cell = Cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        fail(f'{args.workload} needs {cell.chips} cards, '
             f'{torch.cuda.device_count()} visible')
    try:
        import pretorched_tpu_torch
    except ImportError as e:
        fail(f'the program is not in this checkout: {e}')
    if ROOT not in Path(pretorched_tpu_torch.__file__).resolve().parents:
        fail(f'pretorched_tpu_torch loaded from {pretorched_tpu_torch.__file__}'
             f', outside this checkout ({ROOT})')

    result, lines = runner.run_cell(args.workload, args.seed, args.seconds,
                                    args.trace, 'cuda', T0, cell)
    bad = runner.forbidden_modules()
    if bad:
        fail(f'modules that the benchmark may not load were loaded: {bad}', 3)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(runner.dumps(result), flush=True)


if __name__ == '__main__':
    main()
