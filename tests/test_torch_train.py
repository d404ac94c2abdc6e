"""The port's training path against the JAX package's, on the CPU.

A small ``NonLocalResNet3D`` ('basic', layers (1, 1, 1, 1), non-local
blocks (0, 1, 1, 0)) with every BN randomized, the blocks' zero-initialized
``W.1`` included, so that the attention's gradient reaches the loss. The
same numpy inputs go through JAX ``make_train_step(donate=False)`` with
``sgd_step_decay`` and through the port's. Each JAX step is compiled once,
in a module-scoped fixture.

The clips are (2, 3, 4, 64, 64). At 32 px layer4's BN would see 2 values
per channel, and its gradient is so ill-conditioned there that f32 rounding
alone moves the parameter gradients by ~1% (measured against the port in
f64), so a 3-step comparison would compare rounding. At 64 px the JAX f32
gradients are within 5e-5 of the f64 ones, but the CPU's f32 conv3d
backward is not (3e-3 on the stem's weight). Batches of 2 random clips make
the loss steep (parameter gradients in the hundreds), and at lr 0.1 or 0.01
three steps amplify rounding into percent-level differences of the loss.
So the port runs these comparisons in f64 (its attention still computes in
f32) against JAX in f32, at lr 1e-3: the losses agree at 2e-4, and each
parameter's and BN statistic's change over the 3 steps within 5% of the
JAX change's largest element.
The port-only tests (remat, checkpoint, fine-tuning) run in f32. BN alone
against flax at 1e-5.
"""

import os
import signal

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretorched_tpu.models.nonlocalnet import NonLocalResNet3D as JaxNL
from pretorched_tpu.parallel.train import cross_entropy as jax_cross_entropy
from pretorched_tpu.parallel.train import finetune_mask as jax_finetune_mask
from pretorched_tpu.parallel.train import make_train_step as jax_make_train_step
from pretorched_tpu.parallel.train import sgd_step_decay as jax_sgd_step_decay
from pretorched_tpu_torch.models.layers import BatchNorm
from pretorched_tpu_torch.models.nonlocalnet import NonLocalResNet3D
from pretorched_tpu_torch.models.resnet3d import get_fine_tuning_parameter_names
from pretorched_tpu_torch.parallel.train import (cross_entropy, finetune_mask,
                                                 make_train_step,
                                                 sgd_step_decay)
from pretorched_tpu_torch.utils import PreemptionGuard
from pretorched_tpu_torch.zoo.checkpoint import load_checkpoint, save_checkpoint

from torch_port_helpers import (assert_state_matches as _assert_state_matches,
                                port_state_dict, randomize_bn, to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

ARCH = dict(block='basic', layers=(1, 1, 1, 1), num_classes=5,
            shortcut_type='B', nonlocal_layers=(0, 1, 1, 0))
SGD = dict(lr=1e-3, momentum=0.9, weight_decay=1e-4, decay_epochs=1,
           steps_per_epoch=2)          # the staircase drops after step 2
STEPS = 3


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 4, 64, 64).astype(np.float32),
            (np.arange(n) * 3 % 5).astype(np.int64))


@pytest.fixture(scope='module')
def variables():
    """The JAX model's variables, BN (with ``W.1``) randomized, as numpy."""
    jm = JaxNL(expansion=1, **ARCH)
    x, _ = _batch(2)
    return randomize_bn(jm.init(jax.random.key(0), to_nt(x)), seed=4)


def _jax_run(variables, x, labels, accum_steps=1):
    """(losses, final variables as numpy) of STEPS JAX train steps."""
    jm = JaxNL(expansion=1, **ARCH)
    tx = jax_sgd_step_decay(**SGD)
    step = jax_make_train_step(jm, tx, donate=False, accum_steps=accum_steps)
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    stats = jax.tree_util.tree_map(jnp.asarray, variables['batch_stats'])
    opt_state = tx.init(params)
    losses = []
    for i in range(STEPS):
        params, stats, opt_state, m = step(params, stats, opt_state,
                                           jnp.asarray(to_nt(x)),
                                           jnp.asarray(labels), i)
        losses.append(float(m['loss']))
    final = {'params': jax.tree_util.tree_map(np.asarray, params),
             'batch_stats': jax.tree_util.tree_map(np.asarray, stats)}
    return losses, final


@pytest.fixture(scope='module')
def jax_plain(variables):
    x, labels = _batch(2)
    return _jax_run(variables, x, labels)


@pytest.fixture(scope='module')
def jax_accum(variables):
    # a batch of 4 in two microbatches of 2 (a microbatch of 1 would leave
    # layer4's BN one value per channel)
    x, labels = _batch(4, seed=1)
    return _jax_run(variables, x, labels, accum_steps=2)


def _port_model(variables, dtype=torch.float32):
    model = NonLocalResNet3D(**ARCH)
    model.load_state_dict(port_state_dict(variables), strict=True)
    return model.to(dtype)


def _port_run(variables, x, labels, steps=STEPS, dtype=torch.float32, **kw):
    model = _port_model(variables, dtype)
    opt, sched = sgd_step_decay(model.parameters(), **SGD)
    step = make_train_step(model, opt, sched, **kw)
    xt = torch.from_numpy(x).to(dtype)
    losses = [float(step(xt, torch.from_numpy(labels))['loss'])
              for _ in range(steps)]
    return losses, model


def test_train_steps_match_jax(variables, jax_plain):
    want_losses, final = jax_plain
    x, labels = _batch(2)
    losses, model = _port_run(variables, x, labels, dtype=torch.float64)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    assert losses[-1] < losses[0]
    _assert_state_matches(model, final, variables)
    nl = model.layer2[0].nonlocalblock
    assert float(nl.W[1].running_var.sub(1).abs().max()) > 0


def test_accumulated_train_steps_match_jax(variables, jax_accum):
    want_losses, final = jax_accum
    x, labels = _batch(4, seed=1)
    losses, model = _port_run(variables, x, labels, dtype=torch.float64,
                              accum_steps=2)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    _assert_state_matches(model, final, variables)
    # BN statistics moved once per microbatch
    assert int(model.bn1.num_batches_tracked) == 2 * STEPS


@pytest.fixture(scope='module')
def port_plain(variables):
    """(losses, model) of the port's STEPS f32 steps on ``_batch(2)``, the
    uninterrupted run that remat and the checkpoint resume are held to bit
    for bit, on one torch thread as ``one_torch_thread`` runs the tests."""
    x, labels = _batch(2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_run(variables, x, labels)
    finally:
        torch.set_num_threads(threads)


def test_remat_equals_no_remat(variables, port_plain):
    """Checkpointing layer1's blocks changes memory, not numbers, and the
    recompute does not update BN's running statistics a second time."""
    x, labels = _batch(2)
    losses, plain = port_plain
    losses_r, rematted = _port_run(variables, x, labels, remat=(0,))
    assert rematted.remat == (0,)
    assert losses_r == losses
    want = plain.state_dict()
    for key, t in rematted.state_dict().items():
        torch.testing.assert_close(t, want[key], rtol=0, atol=0, msg=key)
    assert int(rematted.layer1[0].bn1.num_batches_tracked) == STEPS


def test_finetune_mask_freezes_bit_for_bit(variables):
    model = _port_model(variables)
    names = get_fine_tuning_parameter_names(4)
    assert names == ['layer4', 'last_linear']
    mask = finetune_mask(model, names)
    # the same trainable set as the JAX mask, by name
    jmask = jax_finetune_mask(variables['params'], names)
    flat = jax.tree_util.tree_flatten_with_path(jmask)[0]
    jax_trainable = {str(path[0].key) for path, v in flat if v}
    assert {n.rsplit('.', 1)[0] for n, v in mask.items() if v} == jax_trainable
    assert all(finetune_mask(model, None).values())

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = sgd_step_decay(
        [p for n, p in model.named_parameters() if mask[n]], **SGD)
    step = make_train_step(model, opt, sched)
    x, labels = _batch(2)
    for _ in range(2):
        step(torch.from_numpy(x), torch.from_numpy(labels))
    for n, p in model.named_parameters():
        if mask[n]:
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n


def test_checkpoint_resume_equals_uninterrupted(variables, port_plain,
                                                tmp_path):
    x, labels = _batch(2)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    _, straight = port_plain

    model = _port_model(variables)
    opt, sched = sgd_step_decay(model.parameters(), **SGD)
    step = make_train_step(model, opt, sched)
    for _ in range(STEPS - 1):
        step(xt, lt)
    path = str(tmp_path / 'checkpoint.pth')
    save_checkpoint(path, {'model': model.state_dict(),
                           'optimizer': opt.state_dict(),
                           'scheduler': sched.state_dict(),
                           'step': STEPS - 1}, is_best=True)
    assert (tmp_path / 'model_best.pth').exists()
    assert not (tmp_path / 'checkpoint.pth.tmp').exists()

    state = load_checkpoint(path)
    assert state['step'] == STEPS - 1
    model2 = NonLocalResNet3D(**ARCH)
    model2.load_state_dict(state['model'])
    opt2, sched2 = sgd_step_decay(model2.parameters(), **SGD)
    opt2.load_state_dict(state['optimizer'])
    sched2.load_state_dict(state['scheduler'])
    assert sched2.get_last_lr() == sched.get_last_lr()
    make_train_step(model2, opt2, sched2)(xt, lt)
    want = straight.state_dict()
    for key, t in model2.state_dict().items():
        torch.testing.assert_close(t, want[key], rtol=0, atol=0, msg=key)


def test_sgd_step_decay_schedule_matches_optax():
    import optax

    kw = dict(lr=0.5, momentum=0.9, weight_decay=0.0, decay_epochs=2,
              steps_per_epoch=3)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = sgd_step_decay([p], **kw)
    want = optax.exponential_decay(0.5, transition_steps=6, decay_rate=0.1,
                                   staircase=True)
    for i in range(14):
        np.testing.assert_allclose(opt.param_groups[0]['lr'],
                                   float(want(i)), rtol=1e-6)
        opt.step()
        sched.step()


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(6, 7).astype(np.float32) * 3
    labels = rng.randint(0, 7, 6)
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits).bfloat16().float(),
                              torch.from_numpy(labels)))
    np.testing.assert_allclose(
        got, float(jax_cross_entropy(
            jnp.asarray(torch.from_numpy(logits).bfloat16().float().numpy()),
            jnp.asarray(labels))), rtol=1e-6)
    np.testing.assert_allclose(
        float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        want, rtol=1e-6)


@pytest.mark.parametrize('shape', [(3, 4), (2, 4, 3), (2, 4, 1, 3, 1)])
def test_batch_norm_train_stats_match_flax(shape):
    """Running statistics after two train-mode updates, at n = 3 and 6 per
    channel, where torch's unbiased variance would be off by n / (n - 1)."""
    rng = np.random.RandomState(6)
    xs = [rng.randn(*shape).astype(np.float32) * 2 + 1 for _ in range(2)]
    c = shape[1]
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    jx = [np.moveaxis(x, 1, -1) for x in xs]
    variables = jbn.init(jax.random.key(0), jx[0])
    stats = variables['batch_stats']
    for x in jx:
        y, upd = jbn.apply({'params': variables['params'],
                            'batch_stats': stats}, x, mutable=['batch_stats'])
        stats = upd['batch_stats']

    bn = BatchNorm(c, eps=1e-5, momentum=0.1).train()
    for x in xs:
        got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats['mean']), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats['var']), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 2
    # eval mode is torch's own
    bn.eval()
    ref = torch.nn.functional.batch_norm(
        torch.from_numpy(xs[0]), bn.running_mean, bn.running_var, bn.weight,
        bn.bias, False, 0.1, 1e-5)
    torch.testing.assert_close(bn(torch.from_numpy(xs[0])), ref)


def test_preemption_guard_latches_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) == prev
