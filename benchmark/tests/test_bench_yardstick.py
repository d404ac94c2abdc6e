"""The frozen yardstick: the analytic FLOP counts against
``torch.utils.flop_counter`` on the plain references at the cells' shapes
(meta tensors, the attention written as plain matmuls), and the bounds
against the numbers the port's records were measured against."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import pretorched_tpu_torch as program
from benchmark.harness.cells import BENCH
from benchmark.yardstick import bounds, count

CONFIGS = sorted(p.stem for p in (BENCH / 'configs').glob('*.json'))


def _config(name):
    with open(BENCH / 'configs' / f'{name}.json') as f:
        return json.load(f)


def _meta_state(cfg):
    with torch.device('meta'):
        model = program.__dict__[cfg['factory']](**cfg['kwargs'])
    return {k: torch.empty(v.shape, dtype=v.dtype, device='meta')
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize('name', CONFIGS)
@pytest.mark.parametrize('train', [False, True])
def test_flops_match_the_flop_counter(name, train):
    import importlib
    cfg = _config(name)
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    arch = importlib.import_module(f"benchmark.yardstick.{cfg['reference']}")
    state = _meta_state(cfg)
    if train:
        state = {k: v.requires_grad_() if v.is_floating_point()
                 and 'running' not in k else v for k, v in state.items()}
    clip = cfg['clip']
    x = torch.empty(2, 3, clip['frames'], clip['crop'], clip['crop'],
                    device='meta')
    with FlopCounterMode(display=False) as counter:
        out = ref.forward(state, cfg, x, train=train)
        if train:
            out.sum().backward()
    assert count.flops(arch.products(cfg), train) * 2 == \
        counter.get_total_flops()


def test_published_sizes():
    """262.2 GFLOP a clip forward for the non-local net (84.3 of them the
    attention), 55.3 for SlowFast; 5 attentions and 11 fused tails."""
    from benchmark.yardstick import nonlocalresnet3d, slowfast
    nl = _config('nonlocalresnet3d50-k400')
    sf = _config('slowfast_resnet50-k400-fused32')
    assert round(count.flops(nonlocalresnet3d.products(nl)) / 1e9, 1) == 262.2
    shapes = nonlocalresnet3d.attention_shapes(nl)
    assert shapes == [(6272, 6272, 256, 256)] * 2 + [(784, 784, 512, 512)] * 3
    assert round(sum(2 * n * k * (c + v) for n, k, c, v in shapes) / 1e9,
                 1) == 84.3
    assert round(count.flops(slowfast.products(sf)) / 1e9, 1) == 55.3
    assert len(slowfast.tail_shapes(sf)) == 11


def test_bounds_are_the_records():
    """The bounds the port's kernel table states (PERF.md): K1-fwd at
    layer 2, B = 20, 0.8146 ms in bf16; K2's 11 tails 0.467 ms a forward of
    20 clips."""
    from benchmark.yardstick import slowfast
    fwd = bounds.attention_bounds(20, 6272, 6272, 256, 256, 'bfloat16')['fwd']
    assert round(fwd * 1e3, 4) == 0.8146
    sf = _config('slowfast_resnet50-k400-fused32')
    k2 = sum(bounds.k2_bound((20, *s), 'bfloat16')
             for s in slowfast.tail_shapes(sf))
    assert round(k2 * 1e3, 3) == 0.467
    # f32 data at the TF32 rate over 3
    assert bounds.PEAK_FLOPS['float32'] == pytest.approx(165e12)
