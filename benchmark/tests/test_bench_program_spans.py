"""The readers of the program's own spans and counters
(``harness/program_spans.py``) on hand-made recordings: figures a step
divided by the step's own spans, the counters' ratio, the kernels'
rooflines at 100 where their spans take exactly the bound, and None where
nothing was recorded or the program records nothing."""

import pytest

from benchmark.harness.cells import Cell
from benchmark.yardstick.bounds import attention_bounds, k2_bound
from pretorched_tpu_torch.utils import profiling

EVAL = ('preprocess_clip_ms.eval', 'host_consts_per_clip.eval',
        'stem_ms.eval', 'eval_step_ms.eval')
TRAIN = ('step_host_ms.train', 'backward_host_ms.train',
         'optimizer_ms.train', 'remat_ms.train', 'k1_kernel_roofline.train')


def _span(device=(), host=()):
    """One name's entry of ``recorded()``: a host time a span at least."""
    return {'device_ms': list(device),
            'host_ms': list(host) or [0.0] * len(device)}


def _run(cell, steps, clips):
    class Run:
        pass
    Run.cell, Run.steps, Run.samples = cell, steps, steps * clips
    return Run


@pytest.fixture
def program(monkeypatch):
    """Sets what the program's ``recorded()`` and ``counters()`` return."""
    state = {'spans': {}, 'counts': {}}
    monkeypatch.setattr(profiling, 'recorded', lambda: state['spans'])
    monkeypatch.setattr(profiling, 'counters', lambda: state['counts'])
    return state


def test_eval_figures_a_step(program):
    cell = Cell('nl50-eval-bf16')
    run = _run(cell, 2, 20)
    program['spans'] = {'eval.step': _span([80.0, 90.0]),
                        'preprocess.clip': _span([1.5] * 40),
                        'stem': _span([50.0, 52.0])}
    program['counts'] = {'preprocess.host_consts': 120,
                         'preprocess.clips': 20}
    got = {m: cell.reader(m)(run) for m in EVAL}
    assert got == pytest.approx({'preprocess_clip_ms.eval': 30.0,
                                 'host_consts_per_clip.eval': 6.0,
                                 'stem_ms.eval': 51.0,
                                 'eval_step_ms.eval': 85.0})
    # SlowFast: two stems a step, summed
    program['spans']['stem']['device_ms'] = [3.0, 1.0, 3.0, 1.0]
    assert Cell('sf50-eval-bf16').reader('stem_ms.eval')(run) == 4.0


def test_train_figures_a_step(program):
    cell = Cell('nl50-train-bf16')
    run = _run(cell, 2, 8)
    program['spans'] = {'train.step': _span(host=[400.0, 410.0]),
                        'train.backward': _span(host=[300.0, 310.0]),
                        'train.optimizer': _span([2.0, 4.0]),
                        'remat.recompute': _span([1.0] * 6)}
    got = {m: cell.reader(m)(run) for m in TRAIN[:4]}
    assert got == pytest.approx({'step_host_ms.train': 405.0,
                                 'backward_host_ms.train': 305.0,
                                 'optimizer_ms.train': 3.0,
                                 'remat_ms.train': 3.0})


def test_kernel_rooflines_at_their_bounds(program):
    nl, sf = Cell('nl50-eval-bf16'), Cell('sf50-eval-bf16')
    shapes = nl.yardstick.attention_shapes(nl.config)
    per_op = [attention_bounds(20, *s, 'bfloat16') for s in shapes]
    tails = [k2_bound((20, *s), 'bfloat16')
             for s in sf.yardstick.tail_shapes(sf.config)]
    program['spans'] = {
        f'k1.{op}': _span([b[op] * 1e3 for b in per_op] * 3)
        for op in ('fwd', 'dq', 'dkv')}
    program['spans']['k2.tail'] = _span([t * 1e3 for t in tails] * 3)
    assert nl.reader('k1_kernel_roofline.eval')(
        _run(nl, 3, 20)) == pytest.approx(100.0)
    assert sf.reader('k2_kernel_roofline.eval')(
        _run(sf, 3, 20)) == pytest.approx(100.0)
    train = Cell('nl50-train-bf16')
    assert train.reader('k1_kernel_roofline.train')(
        _run(train, 3, 20)) == pytest.approx(100.0)
    # twice the time, half the share; a missing backward span, no share
    k2 = program['spans']['k2.tail']
    k2['device_ms'] = [2 * t for t in k2['device_ms']]
    assert sf.reader('k2_kernel_roofline.eval')(
        _run(sf, 3, 20)) == pytest.approx(50.0)
    del program['spans']['k1.dq']
    assert train.reader('k1_kernel_roofline.train')(
        _run(train, 3, 20)) is None


def test_nothing_recorded_reads_none(program, monkeypatch):
    for name, metrics in (('nl50-eval-bf16', EVAL + (
            'k1_kernel_roofline.eval',)), ('sf50-eval-bf16', (
                'k2_kernel_roofline.eval',)), ('nl50-finetune-f32', TRAIN)):
        cell = Cell(name)
        run = _run(cell, 2, 8)
        assert all(cell.reader(m)(run) is None for m in metrics)
    # a program without the tracing functions: the same
    monkeypatch.delattr(profiling, 'recorded')
    monkeypatch.delattr(profiling, 'counters')
    cell = Cell('nl50-eval-bf16')
    assert all(cell.reader(m)(_run(cell, 2, 20)) is None for m in EVAL)
