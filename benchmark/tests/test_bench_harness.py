"""The harness's own behaviour on the CPU: cells found by name, the result
line's shape, the refusals without a card, the import rules."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import runner
from benchmark.harness.cells import BENCH, ROOT, Cell
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = [w['name'] for w in json.loads((ROOT / 'BENCHMARK.json')
                                       .read_text())['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_resolves(name):
    """Every name in BENCHMARK.json finds its files, and every per-layer
    metric it lists has a reader."""
    cell = Cell(name)
    assert cell.end_to_end and cell.per_layer
    assert {'setup_s'} <= {m['name'] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert callable(cell.reader(m['name']))


def test_added_files_are_found(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files
    and entries, in a copy, without an edit to any file that exists."""
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench = tmp_path / 'benchmark'
    cfg = json.loads((bench / 'configs' / 'nonlocalresnet3d50-k400.json')
                     .read_text())
    cfg['name'] = 'nonlocalresnet3d50-k400-b'
    (bench / 'configs' / 'nonlocalresnet3d50-k400-b.json').write_text(
        json.dumps(cfg))
    mix = json.loads((bench / 'traffic' / 'multiclip-eval-bf16.json')
                     .read_text())
    mix['videos_per_step'] = 4
    (bench / 'traffic' / 'multiclip-eval-4.json').write_text(json.dumps(mix))
    (bench / 'workloads' / 'nl50-eval-4.json').write_text(
        (bench / 'workloads' / 'nl50-eval-bf16.json').read_text())
    (bench / 'metrics' / 'steps.eval.py').write_text(
        'def read(run):\n    return float(run.steps)\n')
    spec['configs'].append(dict(spec['configs'][0],
                                name='nonlocalresnet3d50-k400-b'))
    spec['workloads'].append({'name': 'nl50-eval-4', 'chips': 1,
                              'config': 'nonlocalresnet3d50-k400-b',
                              'traffic': 'multiclip-eval-4', 'why': 'test'})
    spec['per_layer'].append({'name': 'steps.eval', 'unit': 'steps',
                              'better': 'higher', 'source': 'host_clock',
                              'layer': 'eval step and model',
                              'moves': 'eval_samples_per_s'})
    for m in spec['end_to_end']:
        if m['name'] in ('eval_samples_per_s', 'step_p95_ms'):
            m['workloads'].append('nl50-eval-4')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    cell = Cell('nl50-eval-4', tmp_path)
    assert cell.config['name'] == 'nonlocalresnet3d50-k400-b'
    assert cell.traffic['videos_per_step'] == 4
    assert 'steps.eval' in [m['name'] for m in cell.per_layer]

    class Run:
        steps = 7
    assert cell.reader('steps.eval')(Run()) == 7.0
    # a metric without a workloads key goes to every cell that reports
    # the end-to-end metric it moves, the existing eval cells too
    assert 'steps.eval' in [m['name'] for m in
                            Cell('sf50-eval-bf16', tmp_path).per_layer]


@pytest.mark.parametrize('name', ['nl50-eval-bf16', 'nl50-finetune-f32'])
def test_result_line(name):
    """The keys of the result line, in order, ``compared`` last; every
    number beside its limit; the end-to-end metrics of the cell."""
    cell = tiny_cell(name, 'float32' if 'eval' in name else 'float64')
    result, lines = run_tiny(cell)
    assert list(result)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                                'device']
    assert list(result)[-1] == 'compared'
    assert set(result['compared']) == set(cell.limits)
    assert all(set(c) == {'value', 'limit'}
               for c in result['compared'].values())
    assert set(result['metrics']) == {m['name'] for m in cell.end_to_end}
    assert all(m['value'] > 0 for m in result['metrics'].values())
    assert result['correct'] and result['failed'] == 0
    assert result['attempted'] > 0
    line = runner.dumps(result)
    assert json.loads(line) == json.loads(json.dumps(result))
    assert '\n' not in line and len(lines) == len(cell.limits) + 1


def test_no_card_no_result():
    """Without CUDA: exit code other than 0, nothing on standard output."""
    out = subprocess.run([sys.executable, str(BENCH / 'run.py'),
                          '--workload', CELLS[0], '--seed', '1',
                          '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0 and out.stdout == ''


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits with another code than 0 and prints no result (here
    at the first refusal it meets)."""
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          CELLS[0], '--seed', '1', '--seconds', '1',
                          '--trace', '0'], capture_output=True, text=True,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ''


def _top_modules(code):
    out = subprocess.run([sys.executable, '-c', code + '\nimport sys\n'
                          'print(sorted({m.split(".")[0] for m in '
                          'sys.modules}))'], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_the_harness():
    """After the harness, every mode, metric, reference and the program
    itself are imported: no JAX module and not the JAX package (whole
    top-level names: the port's name begins with the JAX package's)."""
    code = ('import benchmark.harness.runner, benchmark.modes.eval, '
            'benchmark.modes.train, pretorched_tpu_torch\n'
            'from benchmark.harness.cells import Cell\n'
            f'for name in {CELLS!r}:\n'
            '    cell = Cell(name)\n'
            '    [cell.reader(m["name"]) for m in cell.per_layer]\n')
    found = _top_modules(code)
    assert 'pretorched_tpu_torch' in found
    assert not found & set(runner.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    found = _top_modules('import benchmark.reference.nonlocalresnet3d, '
                         'benchmark.reference.slowfast, '
                         'benchmark.reference.preprocess, '
                         'benchmark.reference.ops')
    assert not found & {'pretorched_tpu_torch', *runner.FORBIDDEN}


class _Event:
    """A kineto event as ``spans.summarize`` reads it."""

    def __init__(self, name, start, end, cuda, annotation=False):
        self._n, self._s, self._e = name, start, end
        self._cuda, self._a = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._a


def test_device_trace_reduction():
    """Busy time is the union of device intervals (overlaps once), the
    window runs from the first to the last, each idle gap goes to the
    innermost benchmark span open on the host when it began."""
    from benchmark.harness.spans import summarize
    ms = 1_000_000
    events = [_Event('k1(int)', 0, 10 * ms, True),
              _Event('k2', 5 * ms, 20 * ms, True),        # overlaps k1
              _Event('k1(int)', 30 * ms, 40 * ms, True),  # after a 10 ms gap
              _Event('bench.k1', 30 * ms, 40 * ms, True, True),  # projection
              _Event('bench.step', 0, 50 * ms, False, True),
              _Event('bench.preprocess', 15 * ms, 25 * ms, False, True),
              _Event('aten::add', 21 * ms, 22 * ms, False)]
    got = summarize(events)
    assert got['busy_s'] == pytest.approx(0.030)
    assert got['window_s'] == pytest.approx(0.040)
    assert [list(x) for x in got['device_ops']] == [['k1', 0.02],
                                                   ['k2', 0.015]]
    assert [list(x) for x in got['idle_gaps']] == [['preprocess', 0.01]]
    assert summarize([_Event('bench.step', 0, 1, False, True)]) is None


def test_readers_of_a_run():
    """A roofline share is 100 where the spans take exactly the bound, and
    absent where the program made no such call; the shares read from the
    configuration's shapes, whatever ran."""
    from benchmark.yardstick.bounds import attention_bounds
    cell = Cell('nl50-eval-bf16')
    shapes = cell.yardstick.attention_shapes(cell.config)

    class Run:
        steps, samples, window_s = 2, 40, 1.0
        span_ms = {'k1.fwd': [attention_bounds(20, *s, 'bfloat16')['fwd'] * 1e3
                              for s in shapes] * 2}
        device_trace = {'busy_s': 0.75, 'window_s': 1.0}
    Run.cell = cell
    assert cell.reader('k1_roofline.eval')(Run) == pytest.approx(100.0)
    assert cell.reader('idle_share.eval')(Run) == pytest.approx(25.0)
    assert 0 < cell.reader('mfu.eval')(Run) < 100
    Run.span_ms = {}
    assert cell.reader('k1_roofline.eval')(Run) is None
    assert Cell('sf50-eval-bf16').reader('k2_roofline.eval')(Run) is None
