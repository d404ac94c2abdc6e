"""The time-sharded ('seq') train step and the tensor-parallel head's train
step (``parallel/seq.py``, ``mesh.py``, ``train.py``, ``zero.py``) against
the port's one-process step and the JAX package, on the CPU.

The models are the JAX dry run's (``__graft_entry__.py:92-146``): a
``VideoResNet('bottleneck', (1, 1, 1, 1))`` with 16 classes, and a
``NonLocalResNet3D`` of the same depth with non-local blocks (0, 1, 1, 0)
and shortcut A, every BN randomized (the blocks' zero-initialized ``W.1``
included, so the attention reaches the loss). The batch is 4 clips at
32 px of 8 and 16 frames, the dry run's 4 frames a shard at S = 2: the
short-shard gather runs from layer 3 on (from the stem at S = 4 and 8
frames). At 32 frames and S = 2 no op gathers (layer 4 runs on 1 frame a
shard): the head pool sums the shards' features over 'seq', the path of a
full-length clip.

Against the port's one-process step: the stacked one-process form with S
= 2 and 4, and ONE launch of four Gloo processes
(``tests/torch_dist_seq_worker.py``, no JAX) running the ('data', 'seq',
'model') meshes (1, 2, 2), (2, 2, 1) and (1, 4, 1) in sequence, then the
tensor-parallel head on ('data', 'model') = (2, 2). The loss and every
gradient within 1e-5 of the largest gradient's norm, in f64: in f32 the
CPU's conv3d weight gradient of the stem alone is 3e-3 (of that norm) off
its f64 value on these random weights, and its rounding changes with the
input's shape, so an f32 comparison of two shardings compares rounding
(the two agree to 1e-13 in f64; the non-local model to 1e-6, its attention
computing in f32 on the CPU).

Against JAX, at the port's train-test tolerances (``tests/
test_torch_train.py``: lr 1e-3, the losses within 2e-4, each parameter's
and BN statistic's change within 5% of the JAX change's largest element),
with both packages in f64 (``jax.enable_x64``; each still computes the
loss's log-softmax and the attention in f32): one step on the (2, 2, 1)
Gloo mesh against JAX's one-device step and JAX's ('data', 'seq') = (2,
2) mesh of virtual CPU devices (the clips sharded ``P('data', 'seq')``,
as the dry run shards them). JAX in f32 cannot be held so: on these
bottleneck models a tensor whose gradient cancels (a BN shift, the stem's
weight) moves by up to 35% of its change between the port's own f32 and
f64 steps. One step: the non-local model's later steps are chaotic on
these weights (the port's own f32 and f64 losses part by 2% at the third
step, at lr 1e-3 to 1e-5; two steps in f64 part by 8% on one tensor).
Not against JAX's ('data', 'seq', 'model') step: once 'seq' and 'model'
both exceed 1, XLA scales the updates of every conv whose window or
stride spans time by the size of 'model' (``ROADMAP.md``, "Gaps in the
reference itself"). The tensor-parallel head against JAX's
step on a ('data', 'model') = (2, 2) mesh with the head column-sharded,
where JAX is correct.
"""

import contextlib
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from pretorched_tpu.models.nonlocalnet import NonLocalResNet3D as JaxNL
from pretorched_tpu.models.resnet3d import VideoResNet as JaxVideoResNet
from pretorched_tpu.parallel.train import make_train_step as jax_train_step
from pretorched_tpu.parallel.train import sgd_step_decay as jax_sgd_step_decay
from pretorched_tpu_torch.models import nonlocalnet
from pretorched_tpu_torch.models.nonlocalnet import NonLocalResNet3D
from pretorched_tpu_torch.models.resnet3d import VideoResNet
from pretorched_tpu_torch.parallel import mesh as meshes
from pretorched_tpu_torch.parallel import seq
from pretorched_tpu_torch.parallel.train import make_train_step

from torch_port_helpers import (jax_variables_from_port, port_state_dict,
                                randomize_port_bn, to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
MODELS = {
    'VideoResNet': (VideoResNet, JaxVideoResNet, dict(
        block='bottleneck', layers=(1, 1, 1, 1), num_classes=16)),
    'NonLocalResNet3D': (NonLocalResNet3D, JaxNL, dict(
        block='bottleneck', layers=(1, 1, 1, 1), num_classes=16,
        nonlocal_layers=(0, 1, 1, 0), shortcut_type='A')),
}
FRAMES = (8, 16)
LONG, LONG_MESHES = 32, ((1, 2, 2), (2, 2, 1))
MESHES = ((1, 2, 2), (2, 2, 1), (1, 4, 1))
LR, TOL = 1e-3, 1e-5
TOL_JAX = 5e-2
TIMEOUT = 300


@pytest.fixture(scope='module')
def carried():
    """Each model's weights (torch's seeded init, every BN randomized),
    the clips (channels-first) and the labels."""
    models = {}
    for i, (name, (cls, _, kw)) in enumerate(MODELS.items()):
        torch.manual_seed(i)
        model = randomize_port_bn(cls(**kw), seed=i)
        models[name] = ({'cls': name, 'kw': kw}, model.state_dict())
    g = torch.Generator().manual_seed(0)
    return {'models': models,
            'clips': {t: torch.randn(4, 3, t, 32, 32, generator=g)
                      for t in FRAMES + (LONG,)},
            'labels': torch.arange(4) * 5 % 16}


@pytest.fixture(scope='module', autouse=True)
def launched(carried, tmp_path_factory):
    """The four workers, started as the file begins (the JAX steps compile
    meanwhile); ``ranks`` waits for them."""
    work = tmp_path_factory.mktemp('torch_dist_seq')
    torch.save(carried, work / 'inputs.pt')
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_dist_seq_worker.py'),
         str(rank), port, str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    yield procs, work
    for p in procs:             # a timed-out sibling must not outlive it
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope='module')
def ranks(launched):
    """The four workers' results, by rank."""
    procs, work = launched
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and \
            f'TORCH-DIST-SEQ-OK rank={rank}' in out, \
            f'worker {rank} failed:\n{out[-4000:]}'
    return [torch.load(work / f'result_{rank}.pt', weights_only=False)
            for rank in range(4)]


def _model(carried, name, dtype=torch.float64):
    cls = MODELS[name][0]
    spec, state = carried['models'][name]
    model = cls(**spec['kw'])
    model.load_state_dict(state)
    return model.to(dtype)


def _step(model, x, labels):
    """One SGD step through ``make_train_step``: (loss, {name: gradient})."""
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    out = make_train_step(model, opt)(x, labels)
    return out['loss'].item(), {n: p.grad.detach().clone()
                                for n, p in model.named_parameters()}


@pytest.fixture(scope='module')
def one_process(carried):
    """The port's one-process f64 step of each model at each length."""
    return {(name, t): _step(_model(carried, name), x.double(),
                             carried['labels'])
            for name in MODELS for t, x in carried['clips'].items()}


def _assert_step_close(loss, grads, want):
    want_loss, want_grads = want
    scale = max(g.norm().item() for g in want_grads.values())
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    assert sorted(grads) == sorted(want_grads)
    for name, g in want_grads.items():
        diff = (grads[name].double() - g.double()).norm().item()
        assert diff <= TOL * scale, (name, diff / scale)


# ----------------------------------------------------------------- the ops
def test_halo_widths():
    """The table of the module docstring: (left, right) per op."""
    assert seq.halo(7, 3, 1) == (3, 3)        # the stem
    assert seq.halo(3, 1, 2) == (1, 0)        # the max pool
    assert seq.halo(3, 1, 1) == (1, 1)        # a block's conv2, stride 1
    assert seq.halo(3, 1, 2) == (1, 0)        # at stride 2
    assert seq.halo(1, 0, 2) == (0, 0)        # shortcut B's 1x1x1 conv


def _whole(rules, out):
    return out if rules.whole else rules.shards.gather(out)


# (kernel, padding, stride, shards, frames a shard); the short ones gather
HALO_CASES = [(7, 3, 1, 2, 4), (7, 3, 1, 4, 2), (3, 1, 1, 2, 1),
              (3, 1, 1, 4, 3), (3, 1, 2, 2, 2), (3, 1, 2, 4, 1),
              (1, 0, 2, 2, 2)]


@pytest.mark.parametrize('k,p,s,shards,length', HALO_CASES)
def test_conv_halo_matches_unsharded_conv(k, p, s, shards, length):
    """A time-sharded conv (its pre-hook's halo, or the short-shard
    gather) and its gradients against the unsharded ``conv3d``."""
    torch.manual_seed(k * 100 + shards * 10 + length)
    conv = torch.nn.Conv3d(3, 4, (k, 3, 3), (s, 1, 1), (p, 1, 1),
                           bias=False).double()
    plain = torch.nn.Conv3d(3, 4, (k, 3, 3), (s, 1, 1), (p, 1, 1),
                            bias=False).double()
    plain.load_state_dict(conv.state_dict())
    rules = seq.SeqRules(seq._Stacked(shards))
    rules.install(torch.nn.Sequential(conv))
    x = torch.randn(2, 3, shards * length, 5, 5, dtype=torch.float64,
                    requires_grad=True)
    short = seq._short(length, k, p, s)
    got = _whole(rules, conv(rules.enter(x)))
    assert rules.whole == short
    want = plain(x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    w = torch.randn_like(want)
    gx, gw = torch.autograd.grad((got * w).sum(), (x, conv.weight))
    wx, ww = torch.autograd.grad((want * w).sum(), (x, plain.weight))
    np.testing.assert_allclose(gx.numpy(), wx.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gw.numpy(), ww.numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize('shards,length', [(2, 4), (4, 2), (2, 3), (4, 1)])
def test_max_pool_halo_matches_unsharded_pool(shards, length):
    """The 3x3x3/2 pool with padding 1 on negative values: the first shard
    pads with -inf (a zero pad would lift its border frames to 0); odd and
    one-frame shards gather. Its gradient too."""
    x = (torch.rand(2, 3, shards * length, 6, 6, dtype=torch.float64) - 2
         ).requires_grad_()
    rules = seq.SeqRules(seq._Stacked(shards))
    got = _whole(rules, rules.max_pool(rules.enter(x), 3, 2, 1))
    assert rules.whole == seq._short(length, 3, 1, 2) or \
        got.shape[2] % shards != 0
    want = F.max_pool3d(x, 3, 2, 1)
    assert float(want.detach().max()) < 0
    np.testing.assert_array_equal(got.detach().numpy(), want.detach().numpy())
    w = torch.randn_like(want)
    np.testing.assert_allclose(
        torch.autograd.grad((got * w).sum(), x)[0].numpy(),
        torch.autograd.grad((want * w).sum(), x)[0].numpy(), rtol=1e-12,
        atol=1e-12)


# ------------------------------------------------------------- the models
@pytest.mark.parametrize('frames', FRAMES + (LONG,))
@pytest.mark.parametrize('shards', [2, 4])
@pytest.mark.parametrize('name', list(MODELS))
def test_stacked_step_matches_one_process(carried, one_process, name,
                                          shards, frames, monkeypatch):
    """The one-process stacked form: loss and gradients equal the
    unsharded step's; the short-shard gather ran (the stream ends whole)
    unless layer 4 gets 2 frames a shard or more (32 frames at S = 2: the
    head pool sums the shards, ``_Stacked.sum``); each non-local block
    attends with its shard's queries to every key."""
    calls = []
    attention = nonlocalnet.auto_nonlocal_attention

    def record(q, k, v, *args):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return attention(q, k, v, *args)

    monkeypatch.setattr(nonlocalnet, 'auto_nonlocal_attention', record)
    model = seq.seq_parallel(_model(carried, name), shards=shards)
    loss, grads = _step(model, carried['clips'][frames].double(),
                        carried['labels'])
    assert model.seq.whole == (frames // shards < 16)
    _assert_step_close(loss, grads, one_process[name, frames])
    if name == 'NonLocalResNet3D':
        assert len(calls) == 2
        for (b, n, _), (bk, nk, _) in calls:
            # sharded: S x 4 rows, keys of S shards; whole: 4 rows
            assert (b, bk) in ((4 * shards,) * 2, (4, 4))
            assert nk == (n * shards if b == 4 * shards else n)
        if frames // shards >= 4:      # layer 2 gets 1 frame a shard or more
            assert calls[0][0][0] == 4 * shards


@pytest.mark.parametrize('frames', FRAMES)
def test_sub_sampled_nonlocal_block_under_seq(carried, frames):
    """A non-local block with ``sub_sample`` (its 2x2x2 key pool) in
    layer 2, stacked S = 2: at 8 frames its shards hold 1 frame and the
    block runs whole, at 16 they hold 2 and pool locally before the key
    gather; the step equals the unsharded one."""
    def model():
        m = _model(carried, 'NonLocalResNet3D')
        torch.manual_seed(7)
        block = nonlocalnet.NonLocalBlock(512, dimension=3, sub_sample=True)
        randomize_port_bn(block, seed=7)
        m.layer2[0].nonlocalblock = block.double()
        return m

    x, labels = carried['clips'][frames].double(), carried['labels']
    want = _step(model(), x, labels)
    loss, grads = _step(seq.seq_parallel(model(), shards=2), x, labels)
    _assert_step_close(loss, grads, want)


# ------------------------------------------------------------------- JAX
def _jax_variables(carried, name):
    cls, jcls, kw = MODELS[name]
    module = jcls(**kw)
    return module, jax_variables_from_port(
        module, carried['models'][name][1], (4, 8, 32, 32, 3))


@jax.enable_x64(True)
def _jax_steps(module, variables, tx, x, labels, steps, mesh=None,
               spec=None, param_spec=None):
    """(losses, final state dict) of ``steps`` JAX steps in f64 (the
    loss and the attention still compute in f32); on ``mesh`` the clips
    are placed by ``spec`` and the parameters by ``param_spec(path)``."""
    step = jax_train_step(module, tx, donate=False)

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      tree)

    params, stats = f64(variables['params']), f64(variables['batch_stats'])
    xb, yb = jnp.asarray(to_nt(x), jnp.float64), jnp.asarray(labels)
    if mesh is not None:
        xb = jax.device_put(xb, NamedSharding(mesh, spec))
        yb = jax.device_put(yb, NamedSharding(mesh, P('data')))
        params = jax.device_put(params, jax.tree_util.tree_map_with_path(
            lambda path, _: NamedSharding(mesh, param_spec(path)), params))
        stats = jax.device_put(stats, NamedSharding(mesh, P()))
    opt = tx.init(params)
    losses = []
    with mesh if mesh is not None else contextlib.nullcontext():
        for i in range(steps):
            params, stats, opt, m = step(params, stats, opt, xb, yb, i)
            losses.append(float(m['loss']))
    return losses, port_state_dict(jax.device_get(
        {'params': params, 'batch_stats': stats}))


def _assert_moved_alike(moved, want, start, tol=TOL_JAX):
    """Each tensor's change over the steps (``moved``) within ``tol`` of
    the largest element of JAX's change (1e-6 at least: the biases that
    feed a BN or a softmax move by weight decay alone)."""
    assert sorted(moved) == sorted(want)
    for key, w in want.items():
        if key.endswith('num_batches_tracked'):
            continue
        want_moved = (w.double() - start[key].double()).numpy()
        scale = max(float(np.abs(want_moved).max()), 1e-6)
        np.testing.assert_allclose(moved[key].double().numpy(), want_moved,
                                   rtol=0, atol=tol * scale, err_msg=key)


def _tp_param_spec(path):
    keys = [str(getattr(p, 'key', '')) for p in path]
    if 'last_linear' in keys:
        return P(None, 'model') if keys[-1] == 'kernel' else P('model')
    return P()


@pytest.fixture(scope='module')
def jax_steps(carried):
    """JAX's results (the state dicts as the port names them): each
    model's step on one device and on a ('data', 'seq') = (2, 2) mesh, and
    two steps of the VideoResNet on ('data', 'model') = (2, 2) with the
    head sharded ``P(None, 'model')``, as the dry run shards it. Requested
    before ``ranks``: they compile while the workers run."""
    x, labels = carried['clips'][8].numpy(), carried['labels'].numpy()
    out = {}
    for name in MODELS:
        module, variables = _jax_variables(carried, name)
        tx = optax.sgd(LR, momentum=0.9)
        jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                     ('data', 'seq'))
        out[name] = (_jax_steps(module, variables, tx, x, labels, 1),
                     _jax_steps(module, variables, tx, x, labels, 1, jmesh,
                                P('data', 'seq'), lambda path: P()))
    module, variables = _jax_variables(carried, 'VideoResNet')
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ('data', 'model'))
    tx = jax_sgd_step_decay(LR, momentum=0.9, weight_decay=1e-4)
    out['tp'] = _jax_steps(module, variables, tx, x, labels, 2, jmesh,
                           P('data'), _tp_param_spec)
    return out


@pytest.mark.parametrize('name', list(MODELS))
def test_seq_mesh_step_matches_jax(carried, jax_steps, ranks, name):
    """A step on the (2, 2, 1) Gloo mesh against JAX's one-device step and
    its ('data', 'seq') = (2, 2) mesh step."""
    got = ranks[0]['seq_jax'][name]
    start = carried['models'][name][1]
    for losses, state in jax_steps[name]:
        np.testing.assert_allclose(got['losses'], losses, rtol=2e-4)
        _assert_moved_alike(got['moved'], state, start)


def test_tp_head_step_matches_jax_mesh(carried, jax_steps, ranks):
    """('data', 'model') = (2, 2): the head column-sharded on each rank
    (Shard(0) of (16, 2048): 8 rows), SGD with momentum and weight decay
    on its DTensors; the losses and the state after two steps against
    JAX's step on the same mesh."""
    tp = ranks[0]['tp']
    assert tp['placement'] == '(Shard(dim=0),)'
    assert tp['local_shape'] == (8, 2048)
    losses, state = jax_steps['tp']
    np.testing.assert_allclose(tp['losses'], losses, rtol=2e-4)
    for r in ranks[1:]:
        assert r['tp']['losses'] == tp['losses']
    _assert_moved_alike(tp['moved'], state,
                        carried['models']['VideoResNet'][1])


def test_tp_head_checkpoint_round_trips(carried, ranks):
    """``full_state_dicts`` gathers the head whole on rank 0 (nothing
    elsewhere); loaded on every rank into a fresh placed model and
    optimizer, one more step equals the original run's exactly."""
    tp = ranks[0]['tp']
    assert tp['saved_keys'] == sorted(carried['models']['VideoResNet'][1])
    assert tp['head_shape'] == (16, 2048)
    assert tp['dtensors'] == []
    assert all(r['tp']['saved_keys'] == [] for r in ranks[1:])
    assert all(r['tp']['resumed_max_diff'] == 0.0 for r in ranks)


def test_ranks_take_their_rows_and_frames(ranks):
    """Each Gloo rank reads its clips' frames (the time cut of
    ``global_batch``): 'data' splits the rows, 'seq' the frames."""
    r = ranks[0]['seq']
    assert r[(1, 2, 2), 'VideoResNet', 8]['frames'] == (4, 3, 4, 32, 32)
    assert r[(2, 2, 1), 'VideoResNet', 16]['frames'] == (2, 3, 8, 32, 32)
    assert r[(1, 4, 1), 'VideoResNet', 8]['frames'] == (4, 3, 2, 32, 32)


def _assert_rank_step_close(got, one_process, name, frames):
    """A worker's step against the one-process step it ran beside it (the
    loss and gradient norms of ``one_process``'s, up to the rounding of
    another thread count), as ``_assert_step_close`` holds two steps."""
    want_loss, want_grads = one_process[name, frames]
    assert abs(got['ref_loss'] - want_loss) <= 1e-12 * abs(want_loss)
    scale = max(got['norm'].values())
    for n, g in want_grads.items():
        assert abs(got['norm'][n] - g.norm().item()) <= 1e-9 * scale
    assert abs(got['loss'] - want_loss) <= TOL * abs(want_loss)
    assert sorted(got['diff']) == sorted(want_grads)
    for n, diff in got['diff'].items():
        assert diff <= TOL * scale, (n, diff / scale)


@pytest.mark.parametrize('name', list(MODELS))
@pytest.mark.parametrize('shape,frames',
                         [(m, t) for t in FRAMES for m in MESHES]
                         + [(m, LONG) for m in LONG_MESHES])
def test_rank_step_matches_one_process(ranks, one_process, shape, name,
                                       frames):
    """Each ('data', 'seq', 'model') mesh on Gloo ranks: every rank's loss
    and reduced gradients equal the one-process step's (the head's too,
    sharded over 'model' at (1, 2, 2)), and the ranks agree exactly. At 32
    frames and S = 2 no op gathers: the head pool all-reduces the shards'
    sums (its backward all-reduces too) and each rank takes 1/S of the
    logits' gradient."""
    key = shape, name, frames
    for r in ranks:
        assert r['seq'][key]['whole'] == (frames != LONG)
        _assert_rank_step_close(r['seq'][key], one_process, name, frames)
        assert r['seq'][key]['loss'] == ranks[0]['seq'][key]['loss']
        for n, f in ranks[0]['seq'][key]['fingerprint'].items():
            assert torch.equal(r['seq'][key]['fingerprint'][n], f), n


def test_remat_replays_the_forward_and_stage_slices_are_refused(
        ranks, one_process):
    """``remat=True`` on (1, 2, 2): the recompute repeats each block's
    exchanges and gather decision, the gradients stay the one-process
    step's; a stage slice raises."""
    for r in ranks:
        _assert_rank_step_close(r['remat'], one_process, 'NonLocalResNet3D',
                                8)
    assert 'stage_slice (0, 2) is not supported' in ranks[0]['stage_slice']
    assert 'call parallel.seq.seq_parallel(model, mesh) first' in \
        ranks[0]['uninstalled']


# ---------------------------------------------------------------- guards
def _refused(model, what):
    with pytest.raises(ValueError, match='ROADMAP.md queue 1') as err:
        seq.seq_parallel(model, shards=2)
    assert what in str(err.value)


@pytest.mark.parametrize('kind', ['factored', 'preact', 's2d_stem',
                                  'cardinality', 'gaussian', 'multiview'])
def test_models_outside_the_scope_raise(kind):
    """R(2+1)D's factored convs, pre-activation blocks, the folded stem,
    grouped convs, a non-local block in another mode and MultiView's
    ResNet are refused, naming the module."""
    small = dict(block='bottleneck', layers=(1, 1, 1, 1), num_classes=4,
                 width_per_stage=(8, 8, 8, 8))
    if kind == 'cardinality':
        _refused(VideoResNet(**{**small, 'width_per_stage': (32,) * 4},
                             cardinality=2), 'groups=2')
    elif kind == 'gaussian':
        model = NonLocalResNet3D(**small, nonlocal_layers=(0, 1, 0, 0))
        model.layer2[0].nonlocalblock.mode = 'gaussian'
        _refused(model, "layer2.0.nonlocalblock (a non-local block in "
                        "'gaussian' mode)")
    elif kind == 'multiview':
        from pretorched_tpu_torch.models.multiview import MVResNet
        _refused(MVResNet('basic', (1, 1, 1, 1), num_classes=4),
                 'the model (MVResNet)')
    else:
        what = {'factored': 'FactoredConv3d', 'preact': 'pre-activation',
                's2d_stem': 'SpaceToDepthConv'}[kind]
        _refused(VideoResNet(**small, **{kind: True}), what)


def test_rules_are_installed_once():
    """``seq_parallel`` takes a model once, and at least 2 shards."""
    small = dict(block='basic', layers=(1, 1, 1, 1), num_classes=4,
                 width_per_stage=(8, 8, 8, 8))
    model = seq.seq_parallel(VideoResNet(**small), shards=2)
    with pytest.raises(ValueError, match='time-sharded already'):
        seq.seq_parallel(model, shards=2)
    with pytest.raises(ValueError, match='nothing to shard'):
        seq.seq_parallel(VideoResNet(**small), shards=1)


def test_make_mesh_takes_three_axes():
    """One process: a ('data', 'seq', 'model') mesh of (1, 1, 1), its
    groups (None where an axis holds one rank), and the shape checks; the
    two-axis default is unchanged."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        mesh = meshes.make_mesh((1, 1, 1), ('data', 'seq', 'model'),
                                device_type='cpu')
        assert mesh.mesh_dim_names == ('data', 'seq', 'model')
        assert meshes.axes_group(mesh, ('data', 'seq')) is None
        assert meshes.make_mesh(device_type='cpu').mesh_dim_names == (
            'data', 'model')
        x = torch.zeros(2, 3, 4, 8, 8)
        assert meshes.global_batch(mesh, x) is x
        with pytest.raises(ValueError, match='has 2 axes'):
            meshes.make_mesh((1, 1), ('data', 'seq', 'model'),
                             device_type='cpu')
        with pytest.raises(ValueError, match='does not hold'):
            meshes.make_mesh((1, 2, 1), ('data', 'seq', 'model'),
                             device_type='cpu')
    finally:
        if started:
            dist.destroy_process_group()


def test_seq_imports_no_jax():
    """In a fresh interpreter ``parallel/seq.py`` imports neither JAX nor
    the JAX package."""
    code = ('import sys; '
            'import pretorched_tpu_torch.parallel.seq; '
            'bad = [m for m in sys.modules if m == "jax" '
            'or m.startswith(("jax.", "pretorched_tpu.")) '
            'or m == "pretorched_tpu"]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], check=True,
                   cwd=os.path.dirname(HERE), timeout=120)
