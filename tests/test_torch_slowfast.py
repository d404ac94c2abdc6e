"""The port's SlowFast against the JAX package's, on the CPU.

JAX models with every BN randomized (``torch_port_helpers.randomize_bn``)
are carried into the port with ``state_dict_from_flax`` and loaded strict;
logits are compared at 2e-3 (whole networks, f32, sums in another order).
Clips are the JAX tests' 32 x 64 x 64. To keep the file cheap, the full
depth ``slowfast_resnet50`` runs through JAX once (module-scoped): with
``fused_blocks=32``, its 11 fused tails through the Pallas kernel in
interpret mode. The other modes, and the basic block, run at depth
(1, 1, 1, 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.slowfast import SlowFast as JaxSlowFast
from pretorched_tpu.parallel.evaluate import \
    multi_clip_eval_step as jax_multi_clip_eval_step
from pretorched_tpu_torch.models import slowfast
from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
from pretorched_tpu_torch.ops.fused_block import \
    fused_bottleneck_tail_reference
from pretorched_tpu_torch.parallel.evaluate import multi_clip_eval_step

from torch_port_helpers import port_state_dict, randomize_bn, to_nt

TOL = 2e-3
VIDEOS, CLIPS = 2, 2
NAMES = ['slowfast_resnet18', 'slowfast_resnet50', 'slowfast_resnet101',
         'slowfast_resnet152', 'slowfast_resnet200']


def _clip(n=1, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 32, 64, 64).astype(
        np.float32)


def _carry(module, x, seed=0, **port_kwargs):
    """(JAX logits of the channels-first ``x``, the port's SlowFast with the
    same randomized-BN weights, loaded strict, in eval mode)."""
    variables = jax.jit(module.init)(jax.random.key(0), to_nt(x[:1]))
    variables = randomize_bn(variables, seed)
    want = np.asarray(jax.jit(module.apply)(variables, to_nt(x)))
    model = slowfast.SlowFast(block=module.block, layers=module.layers,
                              num_classes=module.num_classes,
                              mode=module.mode, **port_kwargs).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    return want, model


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.fixture(scope='module')
def r50():
    """Full-depth slowfast_resnet50 (10 classes), BN randomized: the JAX
    logits with fused_blocks=32 on 2 videos x 2 clips, the clips, and the
    port's model (fused_blocks=32) with the same weights."""
    jm = pretorched_tpu.slowfast_resnet50(num_classes=10, pretrained=None)
    variables = randomize_bn(jm.variables, seed=5)
    clips = _clip(VIDEOS * CLIPS, seed=1)
    fused = dataclasses.replace(jm.module, fused_blocks=32)
    want = np.asarray(jax.jit(fused.apply)(variables, to_nt(clips)))
    model = pretorched_tpu_torch.slowfast_resnet50(
        num_classes=10, pretrained=None, fused_blocks=32).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    return want, clips, model


@pytest.mark.parametrize('mode', ['sf', 's', 'f'])
def test_bottleneck_modes_match_jax(mode):
    x = _clip()
    want, model = _carry(JaxSlowFast(block='bottleneck', layers=(1, 1, 1, 1),
                                     num_classes=10, mode=mode), x)
    np.testing.assert_allclose(_logits(model, x), want, rtol=TOL, atol=TOL)


def test_basic_blocks_match_jax():
    """slowfast_resnet18's basic blocks, at depth (1, 1, 1, 1): conv2 with
    a bias, the stride on conv2 only where head_conv is 3, res3 at stride
    1."""
    x = _clip(seed=2)
    want, model = _carry(JaxSlowFast(block='basic', layers=(1, 1, 1, 1),
                                     num_classes=10, mode='sf'), x, seed=3)
    assert model.slow.res4[0].conv2.bias is not None
    assert model.slow.res4[0].conv2.stride == (1, 2, 2)
    assert model.slow.res2[0].conv1.stride == (1, 1, 1)
    assert model.fast.res3[0].conv2.stride == (1, 1, 1)
    np.testing.assert_allclose(_logits(model, x), want, rtol=TOL, atol=TOL)
    r18 = pretorched_tpu_torch.slowfast_resnet18(num_classes=10)
    assert r18.block == 'basic' and r18.layers == (2, 2, 2, 2)
    assert r18.num_features == 512 + 64


def test_fused_r50_matches_jax_fused_and_unfused(r50):
    """The port's fused tails (the plain version on the CPU) against JAX's
    Pallas tails in interpret mode, and against the port's unfused blocks
    on the same weights (the fold is exact up to rounding: 2e-4)."""
    want, clips, model = r50
    before = fb_cuda.fused_bottleneck_tail_cuda.launches
    fused = _logits(model, clips)
    assert fb_cuda.fused_bottleneck_tail_cuda.launches == before
    np.testing.assert_allclose(fused, want, rtol=TOL, atol=TOL)
    model.fused_blocks = 0
    try:
        plain = _logits(model, clips)
    finally:
        model.fused_blocks = 32
    np.testing.assert_allclose(fused, plain, rtol=2e-4, atol=2e-4)
    assert np.abs(plain).max() > 100 * 2e-4


def test_fused_blocks_selects_the_jax_blocks(r50, monkeypatch):
    """fused_blocks=32 fuses the 11 stride-1 fast bottlenecks with planes <=
    32 (res2 x 3, res3 x 3, res4 x 5; res2.0 with its projection), 64 adds
    fast res5 x 2 and slow res2 x 3 (slow res2.0 projects 80 -> 256)."""
    _, clips, model = r50
    calls = []
    real = slowfast.fused_tail_with_layout

    def counting(y1, x, layout):
        calls.append((tuple(y1.shape), tuple(x.shape), layout.proj))
        return real(y1, x, layout)

    monkeypatch.setattr(slowfast, 'fused_tail_with_layout', counting)
    x = torch.from_numpy(clips[:1])
    with torch.no_grad():
        model(x)
        assert len(calls) == 11 and sum(p for *_, p in calls) == 1
        assert calls[0] == ((1, 8, 16, 16, 16), (1, 8, 16, 16, 16), True)
        calls.clear()
        model.fused_blocks = 64
        try:
            model(x)
        finally:
            model.fused_blocks = 32
    assert len(calls) == 16 and sum(p for *_, p in calls) == 2
    assert ((1, 64, 2, 16, 16), (1, 80, 2, 16, 16), True) in calls


def test_train_mode_never_fuses(monkeypatch):
    def refuse(*args):
        raise AssertionError('a fused tail ran')

    model = slowfast.SlowFast(layers=(2, 1, 1, 1), num_classes=5, mode='f',
                              fused_blocks=32)
    x = torch.from_numpy(_clip(2, seed=6)[:, :, :8, :32, :32])
    monkeypatch.setattr(slowfast, 'fused_tail_with_layout', refuse)
    assert model(x).shape == (2, 5)
    model.eval()
    with pytest.raises(AssertionError, match='a fused tail ran'):
        with torch.no_grad():
            model(x)


def test_multi_clip_eval_step_matches_jax(r50):
    """The whole slice on both sides: 2 videos x 2 clips through each
    package's ``multi_clip_eval_step``, on the same weights and clips. The
    JAX step runs on the JAX model's fused logits of these clips (computed
    once by the fixture), so the file compiles the full JAX net once."""
    want_logits, clips, model = r50

    class _JaxForward:          # the JAX module, its forward already taken
        @staticmethod
        def apply(variables, x):
            return jnp.asarray(want_logits)

    e = np.exp(want_logits - want_logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).reshape(VIDEOS, CLIPS, -1).mean(1)
    ranks = np.argsort(-probs, axis=1)
    labels = np.array([ranks[0, 0], ranks[1, 2]])     # a top-1, a top-5 hit
    shaped = clips.reshape(VIDEOS, CLIPS, *clips.shape[1:])
    want = {k: float(v) for k, v in jax_multi_clip_eval_step(_JaxForward)(
        None, jnp.asarray(np.moveaxis(shaped, 2, -1)),
        jnp.asarray(labels)).items()}
    got = {k: float(v) for k, v in multi_clip_eval_step(model)(
        torch.from_numpy(shaped), torch.from_numpy(labels)).items()}
    assert (want['top1'], want['top5'], want['count']) == (1, 2, 2)
    for k in ('top1', 'top5', 'count'):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=TOL)


def test_s2d_stem_is_a_no_op():
    x = torch.from_numpy(_clip(seed=4)[:, :, :16, :32, :32])
    folded = slowfast.SlowFast(layers=(1, 1, 1, 1), num_classes=10,
                               s2d_stem=True).eval()
    plain = slowfast.SlowFast(layers=(1, 1, 1, 1), num_classes=10).eval()
    plain.load_state_dict(folded.state_dict(), strict=True)
    with torch.no_grad():
        torch.testing.assert_close(folded(x), plain(x), rtol=0, atol=0)


def test_factories_register_as_in_jax():
    for name in NAMES:
        assert name in pretorched_tpu.MODEL_REGISTRY
        assert pretorched_tpu_torch.__dict__[name] is \
            pretorched_tpu_torch.MODEL_REGISTRY[name]
        assert name not in pretorched_tpu_torch.pretrained_settings
    with pytest.raises(KeyError):
        pretorched_tpu_torch.slowfast_resnet50(pretrained='kinetics-400')
    model = pretorched_tpu_torch.slowfast_resnet50(mode='F', num_classes=7)
    assert model.mode == 'f' and model.num_features == 256
    assert model.last_linear.bias is not None and model.settings is None
    assert model.fused_blocks == 0
    v0 = slowfast.SlowFastV0()
    assert v0.mode == 'sf' and v0.num_classes == 10
    assert v0.num_features == 2304 and v0.last_linear.bias is None
    assert pretorched_tpu_torch.models.SlowFastV0 is slowfast.SlowFastV0


def _fused_block(proj, seed=0):
    """A small eval-mode bottleneck (fused) with every BN randomized, and an
    input for it."""
    torch.manual_seed(seed)
    blk = slowfast.Bottleneck(8 if proj else 32, 8, 1, proj, 3)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
    blk.fuse = True
    x = torch.randn(2, 8 if proj else 32, 3, 7, 9)
    return blk.eval(), x


def _plain_tail(blk, x):
    """The plain tail on the block's weights, folded now."""
    y1 = torch.relu(blk.bn1(blk.conv1(x)))
    return fused_bottleneck_tail_reference(y1, x, *blk.tail_weights())


@pytest.mark.parametrize('change', ['bn2_running_var', 'conv3_in_place',
                                    'load_state_dict', 'downsample_bn'])
def test_tail_cache_follows_the_weights(change):
    """The fused block folds its BN once and keeps the layout; a change to
    a source tensor (a BN buffer, a weight in place, a loaded state dict)
    drops it, and the output follows the plain tail on the new weights."""
    blk, x = _fused_block(proj=change == 'downsample_bn')
    with torch.no_grad():
        first = blk(x)
        layout = blk.tail_layout()
        assert blk(x).equal(first) and blk.tail_layout() is layout
        if change == 'bn2_running_var':
            blk.bn2.running_var.mul_(2.0)
        elif change == 'conv3_in_place':
            blk.conv3.weight.mul_(-1.0)
        elif change == 'downsample_bn':
            blk.downsample[1].bias.add_(0.5)
        else:
            other, _ = _fused_block(proj=False, seed=1)
            blk.load_state_dict(other.state_dict())
        got = blk(x)
        assert blk.tail_layout() is not layout
        want = _plain_tail(blk, x)
    assert not torch.allclose(got, first, atol=1e-3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tail_cache_drops_on_train_and_dtype():
    """``.train()`` drops the cached layout and ``.eval()`` rebuilds it at
    the next forward; a cast to bf16 gives a layout of the new dtype."""
    blk, x = _fused_block(proj=True)
    with torch.no_grad():
        blk(x)
        layout = blk.tail_layout()
        blk.train()
        assert blk._tail_cache is None
        blk.eval()
        blk(x)
        assert blk._tail_cache is not None and blk.tail_layout() is not layout
        blk.bfloat16()
        out = blk(x.bfloat16())
        assert blk.tail_layout().folded[0].dtype == torch.bfloat16
        torch.testing.assert_close(out, _plain_tail(blk, x.bfloat16()),
                                   rtol=0, atol=0)


def test_tail_of_a_block_made_in_inference_mode():
    """Parameters made under ``inference_mode`` have no version counter:
    such a block folds at every call, and still gives the plain tail."""
    with torch.inference_mode():
        blk, x = _fused_block(proj=False)
        got = blk(x)
        assert blk.tail_layout() is not blk.tail_layout()
        torch.testing.assert_close(got, _plain_tail(blk, x), rtol=0, atol=0)
