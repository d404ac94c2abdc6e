"""The port's data / tensor / ZeRO layer (``parallel/dist.py``, ``mesh.py``,
``zero.py`` and the mesh steps of ``evaluate.py`` and ``train.py``) against
the JAX package, on the CPU.

The twins of ``tests/test_dist.py``, ``tests/test_zero.py`` and
``tests/test_registry_and_parallel.py``. ``dist.initialize`` runs with
``torch.distributed.init_process_group`` monkeypatched. Everything else
that needs two ranks comes from ONE launch of two Gloo processes
(``tests/torch_dist_worker.py``, no JAX) in a module-scoped fixture, on an
ephemeral port, killed after 240 s; separate tests read its results.

The model is a small BN ResNet (basic blocks, layers (1, 1, 1, 1), widths
(8, 16, 32, 64), 5 classes), every BN randomized, the same weights in both
packages (the JAX results come back through ``state_dict_from_flax``).
The train batch is 8 seeded images at 64 px (layer4's batch norm sees 32
values a channel; at 32 px it sees 8, and f32 rounding alone moves its
gradients, as ``tests/test_torch_train.py`` found for the non-local net).

Tolerances: the sharded eval's counts are exact and its loss sum within
1e-5 (rel) of the single-process port's and 1e-4 of JAX's. Two
data-parallel steps (lr 0.05, momentum 0.9) against the single-process
full-batch step and JAX's mesh step: the losses within 1e-5 and 1e-4, each
parameter and BN statistic within 1e-4 of the largest element of its
change over the two steps (the two runs sum the batch statistics and the
gradients in another order). ZeRO-1 and FSDP against the replicated run:
within 1e-6 (the same arithmetic; FSDP's reduce-scatter sums in another
order).
"""

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
from jax.sharding import Mesh
from PIL import Image

from pretorched_tpu.models.resnet import ResNet as JaxResNet
from pretorched_tpu.parallel import zero as jax_zero
from pretorched_tpu.parallel.evaluate import \
    sharded_accuracy_step as jax_accuracy_step
from pretorched_tpu.parallel.train import make_train_step as jax_train_step
from pretorched_tpu_torch.models.resnet import ResNet
from pretorched_tpu_torch.parallel import dist, mesh, zero
from pretorched_tpu_torch.parallel.evaluate import (pad_batch,
                                                    sharded_accuracy_step)
from pretorched_tpu_torch.parallel.train import make_train_step

from torch_port_helpers import (jax_variables_from_port,  # noqa: F401
                                one_torch_thread, port_state_dict,
                                randomize_port_bn, to_nt)

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTHS, CLASSES, LR, STEPS = (8, 16, 32, 64), 5, 0.05, 2
TIMEOUT = 240


@pytest.fixture(scope='module')
def carried():
    """The JAX module, the port's weights (torch's seeded init, every BN
    randomized) as its variables (numpy, carried on a ``jax.eval_shape``
    template: nothing compiles) and back as a state dict, and the seeded
    batches (channels-first)."""
    rng = np.random.RandomState(0)
    data = {'x_eval': rng.randn(13, 3, 32, 32).astype(np.float32),
            'y_eval': (np.arange(13) % CLASSES).astype(np.int64),
            'x_train': rng.randn(8, 3, 64, 64).astype(np.float32),
            'y_train': (np.arange(8) % CLASSES).astype(np.int64)}
    module = JaxResNet(block='basic', layers=(1, 1, 1, 1),
                       num_classes=CLASSES, width_per_stage=WIDTHS)
    torch.manual_seed(0)
    model = randomize_port_bn(ResNet('basic', (1, 1, 1, 1),
                                     num_classes=CLASSES,
                                     width_per_stage=WIDTHS))
    variables = jax_variables_from_port(module, model.state_dict(),
                                        (1, 32, 32, 3))
    # back through state_dict_from_flax: the dict the workers load, FSDP
    # included, is the flax carrier's
    return module, variables, port_state_dict(variables), data


def _fabricate_images(root):
    rng = np.random.RandomState(1)
    for split, per_class in (('train', 4), ('val', 2)):
        for c in range(2):
            d = root / split / f'n{c:08d}'
            d.mkdir(parents=True)
            for i in range(per_class):
                Image.fromarray(rng.randint(0, 255, (64, 64, 3),
                                            dtype=np.uint8)).save(
                    d / f'img_{i}.jpg')


@pytest.fixture(scope='module')
def ranks(carried, tmp_path_factory):
    """The two workers' results (rank 0's, rank 1's)."""
    _, _, state, data = carried
    work = tmp_path_factory.mktemp('torch_dist')
    torch.save({'state': state, **{k: torch.from_numpy(v)
                                   for k, v in data.items()}},
               work / 'inputs.pt')
    _fabricate_images(work / 'images')
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_dist_worker.py'),
         str(rank), port, str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:          # a timed-out sibling must not outlive it
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f'TORCH-DIST-OK rank={rank}' in out, \
            f'worker {rank} failed:\n{out[-4000:]}'
    return [torch.load(work / f'result_{rank}.pt', weights_only=False)
            for rank in (0, 1)]


# ---------------------------------------------------------- dist.initialize
def _record(monkeypatch):
    called = {}
    monkeypatch.setattr(torch.distributed, 'init_process_group',
                        lambda **kw: called.update(kw))
    return called


def test_initialize_single_process_noop(monkeypatch):
    for var in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(var, raising=False)
    called = _record(monkeypatch)
    assert dist.initialize() is False
    assert not called


def test_initialize_env_var_resolution(monkeypatch):
    """torchrun's variables stand where JAX reads JAX_COORDINATOR_ADDRESS."""
    monkeypatch.setenv('MASTER_ADDR', 'coord.example')
    monkeypatch.setenv('MASTER_PORT', '1234')
    monkeypatch.setenv('WORLD_SIZE', '8')
    monkeypatch.setenv('RANK', '5')
    called = _record(monkeypatch)
    assert dist.initialize(num_processes=4, process_id=2) is True
    assert called == dict(backend='gloo',
                          init_method='tcp://coord.example:1234',
                          world_size=4, rank=2)
    called.clear()
    assert dist.initialize() is True
    assert (called['world_size'], called['rank']) == (8, 5)


def test_initialize_explicit_args(monkeypatch):
    for var in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(var, raising=False)
    called = _record(monkeypatch)
    assert dist.initialize('10.0.0.1:9999', 2, 0) is True
    assert called == dict(backend='gloo', init_method='tcp://10.0.0.1:9999',
                          world_size=2, rank=0)
    with pytest.raises(ValueError, match='rank'):
        dist.initialize('10.0.0.1:9999', 2)


# ------------------------------------------------------------ one process
@pytest.mark.parametrize('shape,min_size', [
    ((64, 128), 2 ** 10), ((63, 129), 2 ** 10), ((8,), 2 ** 10),
    ((3, 3, 64, 128), 2 ** 12), ((128, 64, 3, 3), 2 ** 12),
    ((1000, 512), 2 ** 12), ((7, 7, 3, 64), 2 ** 12)])
@pytest.mark.parametrize('n', [2, 8])
def test_leaf_rule_matches_jax(shape, min_size, n):
    """The dimension a leaf is sharded along: JAX's ``_leaf_spec`` rule."""
    spec = tuple(jax_zero._leaf_spec(np.zeros(shape), 'data', n, min_size))
    want = spec.index('data') if 'data' in spec else None
    assert zero._leaf_dim(shape, n, min_size) == want


def test_no_mesh_is_one_process():
    x = np.arange(6)
    assert mesh.batch_sharding(None) == (0, 1)
    assert mesh.global_batch(None, x) is x
    assert mesh.data_group(None) is None


def test_zero_arguments_are_checked():
    model = ResNet('basic', (1, 1, 1, 1), num_classes=CLASSES,
                   width_per_stage=WIDTHS)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    with pytest.raises(ValueError, match='requires a mesh'):
        make_train_step(model, opt, zero_axis='data')
    with pytest.raises(ValueError, match='requires zero_axis'):
        make_train_step(model, opt, zero_params=True)


def _port_single(state, data, accum=1):
    model = ResNet('basic', (1, 1, 1, 1), num_classes=CLASSES,
                   width_per_stage=WIDTHS)
    model.load_state_dict(state)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    step = make_train_step(model, opt, accum_steps=accum)
    x, y = (torch.from_numpy(data[k]) for k in ('x_train', 'y_train'))
    losses = [float(step(x, y)['loss']) for _ in range(STEPS)]
    return losses, model.state_dict()


def _assert_states_close(got, want, initial, tol):
    """Each tensor within ``tol`` of the largest element of its change
    from ``initial``."""
    assert set(got) == set(want)
    for name in want:
        if name.endswith('num_batches_tracked'):
            assert int(got[name]) == int(want[name]), name
            continue
        change = (want[name].float() - initial[name].float()).abs().max()
        err = (got[name].float() - want[name].float()).abs().max()
        assert err <= tol * max(float(change), 1e-6), (name, float(err),
                                                       float(change))


# ------------------------------------------------------------- two ranks
def test_sharded_eval_of_a_ragged_batch(ranks, carried):
    """13 images, padded to 14 over two ranks, against the port on one
    process and JAX's eval step on the 13."""
    module, variables, state, data = carried
    model = ResNet('basic', (1, 1, 1, 1), num_classes=CLASSES,
                   width_per_stage=WIDTHS).eval()
    model.load_state_dict(state)
    x, y = torch.from_numpy(data['x_eval']), data['y_eval']
    xp, yp = pad_batch(x, y, 2)
    assert len(yp) == 14 and yp[13] == -1
    single = {k: v.item() for k, v in sharded_accuracy_step(model)(
        x, torch.from_numpy(y)).items()}
    want = jax.device_get(jax_accuracy_step(module)(
        variables, jnp.asarray(to_nt(data['x_eval'])), jnp.asarray(y)))
    for got in (ranks[0]['eval'], ranks[1]['eval']):
        assert got['count'] == single['count'] == int(want['count']) == 13
        for k in ('top1', 'top5'):
            assert got[k] == single[k] == int(want[k]), k
        np.testing.assert_allclose(got['loss'], single['loss'], rtol=1e-5)
        np.testing.assert_allclose(got['loss'], float(want['loss']),
                                   rtol=1e-4)


def test_dp_train_matches_full_batch_and_jax_mesh(ranks, carried):
    """Two ranks of 4 images each with batch norm over both: the
    single-process step on all 8, and JAX's step on a 2-device mesh."""
    module, variables, state, data = carried
    dp = ranks[0]['dp']
    assert ranks[1]['dp']['losses'] == dp['losses']
    losses, single = _port_single(state, data)
    np.testing.assert_allclose(dp['losses'], losses, rtol=1e-5)
    _assert_states_close(dp['state'], single, state, 1e-4)

    jmesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                 ('data', 'model'))
    tx = optax.sgd(LR, momentum=0.9)
    step = jax_train_step(module, tx, mesh=jmesh, donate=False)
    params, stats = variables['params'], variables['batch_stats']
    opt = tx.init(params)
    jlosses = []
    for i in range(STEPS):
        params, stats, opt, m = step(params, stats, opt,
                                     jnp.asarray(to_nt(data['x_train'])),
                                     jnp.asarray(data['y_train']), i)
        jlosses.append(float(m['loss']))
    jstate = port_state_dict(jax.device_get({'params': params,
                                             'batch_stats': stats}))
    np.testing.assert_allclose(dp['losses'], jlosses, rtol=1e-4)
    # flax counts no BN batches
    jstate = {k: dp['state'][k] if k.endswith('num_batches_tracked')
              else jstate[k] for k in dp['state']}
    _assert_states_close(dp['state'], jstate, state, 1e-4)


@pytest.mark.parametrize('run', ['zero1', 'zero1_accum', 'fsdp',
                                 'fsdp_accum'])
def test_zero_matches_replicated(ranks, run):
    """ZeRO-1 and FSDP, with accum_steps 1 and 2, against the replicated
    data-parallel run of the same accumulation."""
    want = ranks[0]['dp_accum' if run.endswith('accum') else 'dp']
    got = ranks[0][run]
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-6)
    assert ranks[1][run]['losses'] == got['losses']
    assert not ranks[1][run]['state'], 'only rank 0 gathers the state'
    for name, t in want['state'].items():
        np.testing.assert_allclose(got['state'][name].float().numpy(),
                                   t.float().numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f'{run} {name}')


@pytest.mark.parametrize('run', ['zero1', 'fsdp'])
def test_zero_memory_claim(ranks, run):
    """Each rank holds about half the momentum bytes of the replicated
    run (<= 0.6x)."""
    for res in ranks:
        assert res[run]['opt_bytes'] <= 0.6 * res['dp']['opt_bytes'], (
            res[run]['opt_bytes'], res['dp']['opt_bytes'])


def test_accumulation_steps_differ_from_full_batch(ranks):
    """accum_steps=2 normalizes each half batch on its own: a different
    run (the check that the accumulated runs above compare something)."""
    assert ranks[0]['dp_accum']['losses'][0] != ranks[0]['dp']['losses'][0]


def test_fsdp_model_loads_a_whole_state_dict(ranks):
    assert ranks[0]['fsdp_load'] <= 1e-6 and ranks[1]['fsdp_load'] <= 1e-6


def test_tp_head_is_column_sharded(ranks):
    """A 100-class head on a (1, 2) mesh: each rank holds 50 of its rows
    (the JAX kernel's columns), and the logits are gathered whole."""
    for res in ranks:
        tp = res['tp100']
        assert tp['placement'] == 'S(0)' and tp['dtensor']
        assert tp['local_shape'] == (50, 512)
        assert tp['logits_shape'] == (8, 100) and tp['max_diff'] <= 1e-5


def test_indivisible_head_stays_replicated(ranks):
    for res in ranks:
        tp = res['tp101']
        assert tp['placement'] == 'R' and not tp['dtensor']
        assert tp['local_shape'] == (101, 512) and tp['max_diff'] == 0.0


@pytest.mark.parametrize('zero', ['1', 'fsdp'])
def test_cli_zero_on_two_processes(ranks, zero):
    """``imagenet_eval_torch.py --zero [fsdp]`` on two processes: each
    trains on its shard (8 images, -b 2: 2 steps), validation sums the
    whole 4-image val set on both, only rank 0 writes the checkpoint."""
    r0, r1 = ranks[0][f'cli_{zero}'], ranks[1][f'cli_{zero}']
    assert r0['train_steps'] == r1['train_steps'] == 2
    assert r0['totals'] == r1['totals'] and r0['totals']['count'] == 4
    assert r0['checkpoint'] and not r1['checkpoint']
