"""The plain references against the port from the same state dict, at a
size the CPU holds: both architectures' eval forwards, the non-local net's
train-mode forward and gradients, and the preprocess."""

import json

import pytest
import torch
import torch.nn.functional as F

import pretorched_tpu_torch as program
from benchmark.harness.cells import BENCH
from benchmark.harness.weights import seeded_state
from benchmark.reference import nonlocalresnet3d, preprocess, slowfast

# the fused tail takes float32 and bfloat16 only
CASES = [('nonlocalresnet3d50-k400', nonlocalresnet3d, 8, torch.float64),
         ('slowfast_resnet50-k400-fused32', slowfast, 32, torch.float32)]


def _model(name, seed=3, dtype=torch.float64):
    with open(BENCH / 'configs' / f'{name}.json') as f:
        cfg = json.load(f)
    model = program.__dict__[cfg['factory']](**cfg['kwargs']).to(dtype)
    state = seeded_state(model, seed, 'cpu', **cfg['init'])
    model.load_state_dict(state, strict=True)
    return cfg, model, state


@pytest.mark.parametrize('name,ref,frames,dtype', CASES)
def test_eval_forward(name, ref, frames, dtype):
    """The non-local net in float64 but for what the port computes in
    float32 whatever its input (the attention's plain version): 1.2e-6
    here; SlowFast in float32: 2.5e-7; 1e-5 allowed."""
    cfg, model, state = _model(name, dtype=dtype)
    x = torch.randn(2, 3, frames, 48, 48, generator=torch.Generator()
                    .manual_seed(0), dtype=dtype)
    with torch.no_grad():
        got = model.eval()(x)
        want = ref.forward(state, cfg, x)
    assert ((got - want).norm() / want.norm()).item() < 1e-5


def test_train_forward_and_gradients():
    """Every parameter's gradient within 1e-4 of the largest gradient's
    norm (1.8e-5 here: the port's attention runs in float32)."""
    cfg, model, state = _model('nonlocalresnet3d50-k400')
    x = torch.randn(3, 3, 8, 48, 48, generator=torch.Generator()
                    .manual_seed(1), dtype=torch.float64)
    labels = torch.tensor([3, 7, 11])
    F.cross_entropy(model.train()(x), labels).backward()
    names = [n for n, _ in model.named_parameters()]
    params = {n: state[n].clone().requires_grad_() for n in names}
    buffers = {k: v for k, v in state.items() if k not in params}
    loss = F.cross_entropy(nonlocalresnet3d.forward({**params, **buffers},
                                                    cfg, x, train=True),
                           labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    scale = max(g.norm() for g in grads)
    for (n, p), g in zip(model.named_parameters(), grads):
        assert ((p.grad - g).norm() / scale).item() < 1e-4, n


def test_preprocess():
    """The reference's resize, crop and normalize against the port's
    ``preprocess_clip`` in float32: within 1e-4 of a normalized unit (the
    port builds its weights in float32, the reference in float64)."""
    from pretorched_tpu_torch.transforms.fused import preprocess_clip
    with open(BENCH / 'configs' / 'nonlocalresnet3d50-k400.json') as f:
        settings = json.load(f)['preprocess']
    frames = torch.randint(0, 256, (4, 240, 320, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    got = preprocess_clip(frames, settings, channels_last=False)[0]
    want = preprocess.clip(frames, settings)
    assert got.shape == want.shape == (3, 4, 224, 224)
    assert (got - want).abs().max().item() < 1e-3
