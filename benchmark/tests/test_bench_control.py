"""The control of each cell's check comes out not correct.

The control is the plain reference put in the program's place in the
precision below the traffic's: float8 operands (per-tensor scaled) for
bfloat16, TF32 for float32 with TF32 off. Held to the float32 reference
by the numbers a run compares, it has to read above one of the cell's
limits. On the CPU at a small size for the bfloat16 cells; TF32 exists
only on the card, so the float32 cell's control is a ``gpu`` test, at a
reduced clip. ``benchmark/control.py`` reads it at the cells' own sizes.
"""

import pytest
import torch

from benchmark.control import control_readings
from benchmark.tests.tiny import tiny_cell

BF16 = ['nl50-eval-bf16', 'sf50-eval-bf16', 'nl50-train-bf16']


def _fails(cell, readings):
    return any(not v <= cell.limits[k] for k, v in readings.items()
               if k in cell.limits)


@pytest.mark.parametrize('name', BF16)
def test_float8_control_fails(name):
    cell = tiny_cell(name, 'bfloat16')
    assert _fails(cell, control_readings(cell, 2 ** 31 + 9, 'cpu'))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('TF32 runs only on a CUDA card')
    return 'cuda'


@pytest.mark.gpu
def test_tf32_control_fails(card):
    cell = tiny_cell('nl50-finetune-f32', 'float32')
    cell.config['clip'] = {'frames': 16, 'crop': 112}
    assert _fails(cell, control_readings(cell, 2 ** 31 + 9, card))
