"""A run from the command line's arguments to the result's line."""

from __future__ import annotations

import json
import math
import sys

import torch

from .cells import Cell
from .common import Run, p95

# modules no part of a run may load (compared by top-level name, whole)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pretorched_tpu')


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules}
                  & set(FORBIDDEN))


def end_to_end(run):
    """Every end-to-end quantity a run of this mode gives."""
    rate = run.samples / run.window_s
    return {'setup_s': run.setup_s, f'{run.cell.mode}_samples_per_s': rate,
            'step_p95_ms': p95(run.intervals_ms)}


def judge(readings, limits):
    """{number: {'value', 'limit'}} and whether every number is within its
    limit (a number that is not finite is not)."""
    compared = {name: {'value': readings[name], 'limit': limit}
                for name, limit in limits.items()}
    ok = all(math.isfinite(c['value']) and c['value'] <= c['limit']
             for c in compared.values())
    return compared, ok


def run_cell(name, seed, seconds, trace, device='cuda', t0=0.0, cell=None):
    """One run; returns (result dict, the compared numbers' lines)."""
    cell = cell or Cell(name)
    if device == 'cuda':
        tf32 = cell.traffic['tf32']
        torch.backends.cuda.matmul.allow_tf32 = tf32['matmul']
        torch.backends.cudnn.allow_tf32 = tf32['cudnn']
    run = Run(cell, seed, seconds, trace, device, t0)
    evidence = cell.mode_module.measure(run)
    run.free()
    readings, failed = cell.mode_module.readings(run, evidence)
    compared, ok = judge(readings, cell.limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m['name'])(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = end_to_end(run)
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    result = {'correct': ok and failed == 0, 'attempted': run.samples,
              'failed': failed, 'metrics': metrics,
              'device': {'platform': 'gpu' if run.cuda else 'cpu',
                         'kind': (torch.cuda.get_device_name(run.device)
                                  if run.cuda else 'cpu'),
                         'count': cell.chips,
                         'memory_peak_bytes': run.peak_bytes}}
    if trace and run.device_trace:
        result['device'].update(busy_s=run.device_trace['busy_s'],
                                window_s=run.device_trace['window_s'])
        result['breakdown'] = {
            'device_ops': [list(kv) for kv in run.device_trace['device_ops']],
            'idle_gaps': [list(kv) for kv in run.device_trace['idle_gaps']]}
    result['compared'] = compared
    lines = [f'{k} {c["value"]!r} (limit {c["limit"]!r})'
             for k, c in compared.items()]
    others = {k: v for k, v in readings.items() if k not in compared}
    if others:
        print(f'readings without a limit: {others}', flush=True)
    lines.append(f'failed {failed} of {run.samples} (limit 0)')
    return result, lines


def dumps(result):
    return json.dumps(result, separators=(', ', ': '))
