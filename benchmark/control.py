#!/usr/bin/env python3
"""The control of a cell's correctness check, at the cell's own size.

    python3 benchmark/control.py --workload NAME --seeds N [N ...]

For each seed: the cell's inputs and seeded weights as a run makes them,
then the plain reference put in the program's place in the precision
below the traffic's (TF32 for float32 with TF32 off, float8 operands for
bfloat16), held to the float32 reference by the same numbers a run
compares. With ``--fault`` (training cells) the reference in float32
with that fault planted instead. Prints one JSON line a seed: each
number beside the cell's limit. A benchmark run never runs this; it is
how the limits' upper readings are taken, and it has to come out above
them.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_readings(cell, seed, device='cuda', fault=None):
    from benchmark.harness.common import Run, seeded_model
    run = Run(cell, seed, 0, 0, device, time.perf_counter())
    evidence = cell.mode_module.inputs(run)
    model, evidence['state'] = seeded_model(run)
    evidence['names'] = [n for n, _ in model.named_parameters()]
    args = [fault] if fault else []
    return cell.mode_module.control(run, evidence, *args)[0]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--fault', default=None,
                   help='a training cell\'s fault (modes/train.FAULTS) in '
                        'the reference in float32, in place of the control')
    args = p.parse_args()
    import torch
    from benchmark.harness.cells import Cell
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    cell = Cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_readings(cell, seed, fault=args.fault)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'fault': args.fault,
                          'seconds': time.perf_counter() - t0,
                          'control': {k: {'value': v,
                                          'limit': cell.limits.get(k)}
                                      for k, v in got.items()}}), flush=True)


if __name__ == '__main__':
    main()
