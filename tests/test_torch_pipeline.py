"""The port's pipeline parallelism (``parallel/pipeline.py``), the resnet3d
stage functions and the two-rank mesh paths of pipeline, expert
parallelism and sharded serving, against the JAX package, on the CPU.

The twins of ``tests/test_pipeline_parallel.py`` and
``tests/test_pipeline_stages.py``:

* a homogeneous trunk of the JAX test's residual conv blocks (flax
  parameters initialized in JAX, stacked through the port's
  ``stack_block_params`` as numpy): ``pipeline_apply`` over 2, 4 and 8
  stages in one process (``devices=['cpu'] * S``) against
  ``sequential_apply`` and JAX's ``pipeline_apply`` on 4 of the 8 virtual
  devices, forward and gradients; the warm-up ticks of a block that is NaN
  on zeros; ``stage_sharding``'s blocks per device;
* a small ``VideoResNet`` (bottleneck, layers (1, 1, 1, 1), widths (8, 16,
  32, 64), every BN randomized, carried to JAX): the stage split covers
  every key once, the four stage functions composed equal JAX's forward,
  the four-stage pipeline equals JAX's ``pipeline_apply_stages``;
* a small ``NonLocalResNet3D`` (the same trunk, ``nonlocal_layers=(0, 1,
  1, 0)``) pipelined over its four stages equals JAX's whole forward (its
  ``__call__`` has no ``stage_slice``), and zeroing the blocks' ``W.1``
  moves the logits;
* the mesh paths at world size 1 (a one-process Gloo group made here and
  destroyed after): ``pipeline_apply``, ``pipeline_apply_stages`` and a
  served ``mesh.sharded_apply`` against the in-process results;
* ONE launch of two Gloo ranks (``tests/torch_dist_pipeline_worker.py``,
  no JAX), on an ephemeral port, killed after 180 s: a rank holds L / 2
  blocks, the pipelined output and gradients equal one process's, DP x PP
  and its batch guard, the expert-sharded ``moe_apply`` and
  ``mstrn_expert_apply`` (E / 2 experts a rank; the MoE twins themselves
  are in ``tests/test_torch_moe.py``), and ``sharded_apply`` outside a
  server.

Tolerances: the pipeline against the sequential application 1e-5; the
port against JAX 2e-4 for blocks and 2e-3 for whole nets.
"""

import os
import socket
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pretorched_tpu.models.nonlocalnet import \
    NonLocalResNet3D as JaxNonLocalResNet3D
from pretorched_tpu.models.resnet3d import VideoResNet as JaxVideoResNet
from pretorched_tpu.models.resnet3d import \
    pipeline_stage_fns as jax_stage_fns
from pretorched_tpu.models.resnet3d import \
    split_stage_variables as jax_split
from pretorched_tpu.parallel import pipeline as jax_pp
from pretorched_tpu_torch.models.nonlocalnet import (NonLocalBlock,
                                                     NonLocalResNet3D)
from pretorched_tpu_torch.models.resnet3d import (VideoResNet,
                                                  pipeline_stage_fns,
                                                  split_stage_variables)
from pretorched_tpu_torch.models.trn import MultiScaleRelation
from pretorched_tpu_torch.parallel import mesh as meshes
from pretorched_tpu_torch.parallel import moe
from pretorched_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                    pipeline_apply_stages,
                                                    sequential_apply,
                                                    stack_block_params,
                                                    stage_sharding)
from pretorched_tpu_torch.serving import InferenceServer

from torch_dist_pipeline_worker import MSTRN, block_fn, expert_fn
from torch_port_helpers import (jax_variables_from_port, randomize_port_bn,
                                run_jax, to_nt)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 180
TRUNK = dict(block='bottleneck', layers=(1, 1, 1, 1),
             width_per_stage=(8, 16, 32, 64), shortcut_type='B')


class ResidualConvBlock(nn.Module):
    """The JAX test's shape-preserving conv residual block."""
    ch: int = 8

    @nn.compact
    def __call__(self, x):
        h = nn.Conv(self.ch, (3, 3), padding='SAME', name='conv1')(x)
        h = nn.gelu(h)
        h = nn.Conv(self.ch, (3, 3), padding='SAME', name='conv2')(h)
        return x + 0.5 * h


def _nchw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _torch_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _torch_leaves(tree[k])]
    return [tree]


@pytest.fixture(scope='module')
def trunk():
    """8 blocks' flax parameters (numpy), a seeded (16, 8, 6, 6) batch, and
    JAX's results: ``pipeline_apply`` over 4 stages (4 microbatches) and
    the gradients of mean(out ** 2) through ``sequential_apply``."""
    block = ResidualConvBlock()
    init = jax.jit(block.init)
    params = [jax.tree_util.tree_map(np.asarray, init(
        jax.random.key(i), jnp.zeros((1, 6, 6, 8)))['params'])
        for i in range(8)]
    x = np.random.RandomState(0).randn(16, 6, 6, 8).astype(np.float32)

    def jblock(p, h):
        return block.apply({'params': p}, h)

    stacked = jax_pp.stack_block_params(params)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ('stage',))
    out = jax_pp.pipeline_apply(jblock, stacked, jnp.asarray(x), mesh,
                                n_micro=4)
    grads = jax.grad(lambda p, h: jnp.mean(
        jax_pp.sequential_apply(jblock, p, h) ** 2), argnums=(0, 1))(
        stacked, jnp.asarray(x))
    return {'params': params, 'x': np.moveaxis(x, -1, 1),
            'out': _nchw(out), 'grads': grads}


def _port_stack(trunk):
    return stack_block_params(trunk['params'])


@pytest.mark.parametrize('stages,n_micro', [(4, 4), (2, 8), (8, 8)])
def test_pipeline_forward_matches_sequential_and_jax(trunk, stages, n_micro):
    stacked = _port_stack(trunk)
    x = torch.from_numpy(trunk['x'])
    with torch.no_grad():
        out = pipeline_apply(block_fn, stacked, x, devices=['cpu'] * stages,
                             n_micro=n_micro)
        ref = sequential_apply(block_fn, stacked, x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), trunk['out'], rtol=2e-4,
                               atol=2e-4)


def test_pipeline_gradients_match_sequential_and_jax(trunk):
    def grads(run):
        stacked = _port_stack(trunk)
        for leaf in _torch_leaves(stacked):
            leaf.requires_grad_()
        x = torch.from_numpy(trunk['x']).requires_grad_()
        (run(stacked, x) ** 2).mean().backward()
        return [leaf.grad for leaf in _torch_leaves(stacked)] + [x.grad]

    g_pp = grads(lambda p, x: pipeline_apply(block_fn, p, x,
                                             devices=['cpu'] * 4, n_micro=4))
    g_seq = grads(lambda p, x: sequential_apply(block_fn, p, x))
    want_p, want_x = trunk['grads']
    want = _leaves(want_p) + [_nchw(want_x)]
    assert len(g_pp) == len(want)
    for a, b, w in zip(g_pp, g_seq, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_pipeline_masks_nonfinite_warmup_ticks():
    """A block that is NaN on zero-filled activations leaks nothing: the
    warm-up and drain ticks run no stage."""
    def norm_fn(p, x):
        return p['s'] * x / torch.linalg.norm(x, dim=-1, keepdim=True)

    stacked = {'s': torch.ones(4, 1)}
    x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(8, 4))
                         .astype(np.float32) + 0.1)
    out = pipeline_apply(norm_fn, stacked, x, devices=['cpu'] * 4, n_micro=4)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(),
                               sequential_apply(norm_fn, stacked, x).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_stage_sharding_splits_param_memory(trunk):
    stacked = _port_stack(trunk)
    per_device = stage_sharding(None, stacked, devices=['cpu'] * 4)
    assert len(per_device) == 4
    for shard in per_device:
        assert shard['conv1']['kernel'].shape == (2, 3, 3, 8, 8)
    x = torch.from_numpy(trunk['x'])
    with torch.no_grad():
        out = pipeline_apply(block_fn, per_device, x, devices=['cpu'] * 4,
                             n_micro=4)
        ref = sequential_apply(block_fn, stacked, x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_batch_guard_in_one_process():
    with pytest.raises(AssertionError, match='data shards'):
        pipeline_apply(block_fn, {}, torch.zeros(6, 8, 6, 6),
                       devices=['cpu'] * 4, n_micro=4)


def _carried(module, model, x):
    """The port's weights (seeded init, every BN randomized) in JAX."""
    randomize_port_bn(model).eval()
    variables = jax_variables_from_port(module, model.state_dict(),
                                        (1,) + to_nt(x).shape[1:])
    return variables


@pytest.fixture(scope='module')
def video():
    """The small VideoResNet in both packages on 8 seeded clips of 4 x 32 x
    32, with JAX's forward and its four-stage pipeline (4 of the virtual
    devices, 4 microbatches)."""
    torch.manual_seed(0)
    model = VideoResNet(num_classes=12, **TRUNK)
    module = JaxVideoResNet(num_classes=12, **TRUNK)
    x = np.random.RandomState(2).randn(8, 3, 4, 32, 32).astype(np.float32)
    variables = _carried(module, model, x)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ('stage',))
    piped = jax_pp.pipeline_apply_stages(jax_stage_fns(module),
                                         jax_split(variables),
                                         jnp.asarray(to_nt(x)), mesh,
                                         n_micro=4)
    want = run_jax(lambda v, h: module.apply(v, h), variables, to_nt(x))
    return model, x, np.asarray(want), np.asarray(piped)


def test_stage_variables_partition_everything(video):
    model = video[0]
    state = model.state_dict()
    subs = split_stage_variables(state)
    assert len(subs) == 4
    keys = [k for sub in subs for k in sub]
    assert sorted(keys) == sorted(state)
    assert all(k.startswith('layer2.') for k in subs[1])


def test_stage_slices_compose_to_jax_forward(video):
    model, x, want, _ = video
    h = torch.from_numpy(x)
    with torch.no_grad():
        for fn, sub in zip(pipeline_stage_fns(model),
                           split_stage_variables(model.state_dict())):
            h = fn(sub, h)
        whole = model(torch.from_numpy(x))
    assert torch.equal(h, whole)
    np.testing.assert_allclose(h.numpy(), want, rtol=2e-3, atol=2e-3)


def test_resnet3d_stage_pipeline_matches_jax_pipeline(video):
    model, x, want, piped = video
    with torch.no_grad():
        out = pipeline_apply_stages(
            pipeline_stage_fns(model),
            split_stage_variables(model.state_dict()), torch.from_numpy(x),
            devices=['cpu'] * 4, n_micro=4)
        whole = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), piped, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(piped, want, rtol=1e-5, atol=1e-5)


def test_nonlocal_resnet3d_pipeline_matches_jax_forward():
    """Stages 1 and 2 hold the non-local blocks (K1-fwd on the card); the
    four stages composed in the pipeline equal JAX's whole forward."""
    torch.manual_seed(1)
    kw = dict(num_classes=6, nonlocal_layers=(0, 1, 1, 0), **TRUNK)
    model = NonLocalResNet3D(**kw)
    module = JaxNonLocalResNet3D(**kw)
    x = np.random.RandomState(3).randn(8, 3, 8, 32, 32).astype(np.float32)
    variables = _carried(module, model, x)
    want = np.asarray(run_jax(lambda v, h: module.apply(v, h), variables,
                              to_nt(x)))
    stages = split_stage_variables(model.state_dict())
    assert any('nonlocalblock' in k for k in stages[1])
    assert any('nonlocalblock' in k for k in stages[2])

    def piped():
        with torch.no_grad():
            return pipeline_apply_stages(
                pipeline_stage_fns(model),
                split_stage_variables(model.state_dict()),
                torch.from_numpy(x), devices=['cpu'] * 4, n_micro=4).numpy()

    got = piped()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, NonLocalBlock):
                m.W[1].weight.zero_()
    moved = np.linalg.norm(piped() - got) / np.linalg.norm(got)
    assert moved > 1e-3, moved


def test_nonlocal_pipeline_gradients_match_unpipelined():
    """The backward through the four pipelined stages (4 microbatches) gives
    every parameter the unpipelined backward's gradient, for a loss linear
    in the logits; a key's bias (``phi.bias``) shifts a softmax row alike
    and has no gradient but rounding noise in either."""
    torch.manual_seed(1)
    model = randomize_port_bn(NonLocalResNet3D(
        num_classes=6, nonlocal_layers=(0, 1, 1, 0), **TRUNK)).eval()
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(8, 3, 8, 32, 32).astype(np.float32))
    weights = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    params = dict(model.named_parameters())

    def grads(run):
        model.zero_grad()
        (run() * weights).sum().backward()
        return {k: p.grad.clone() for k, p in params.items()}

    got = grads(lambda: pipeline_apply_stages(
        pipeline_stage_fns(model),
        split_stage_variables(model.state_dict(keep_vars=True)), x,
        devices=['cpu'] * 4, n_micro=4))
    want = grads(lambda: model(x))
    for k in params:
        if k.endswith('phi.bias'):
            assert float(want[k].abs().max()) < 1e-6
            continue
        rel = float((got[k] - want[k]).norm() / want[k].norm())
        assert rel <= 1e-5, (k, rel)


@pytest.fixture(scope='module')
def one_process_mesh():
    """A ('data', 'stage') mesh of this process alone (Gloo), destroyed
    after the module's tests."""
    mesh = meshes.make_mesh((1, 1), ('data', 'stage'), device_type='cpu')
    yield mesh
    torch.distributed.destroy_process_group()


def test_mesh_paths_at_world_size_one(one_process_mesh, trunk, video):
    mesh = one_process_mesh
    stacked = _port_stack(trunk)
    x = torch.from_numpy(trunk['x'])
    model, clips = video[0], torch.from_numpy(video[1])
    with torch.no_grad():
        got = pipeline_apply(block_fn, stacked, x, mesh, n_micro=4,
                             batch_axes=('data',))
        want = pipeline_apply(block_fn, stacked, x, devices=['cpu'],
                              n_micro=4)
        whole = [lambda s, h: torch.func.functional_call(model, s, (h,))]
        got_stages = pipeline_apply_stages(whole, [model.state_dict()], clips,
                                           mesh, n_micro=2)
        want_stages = model(clips)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got_stages.numpy(), want_stages.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_server_with_sharded_apply(one_process_mesh):
    """The counterpart of ``tests/test_serving.py``'s sharded apply: an
    ``apply_fn`` cut over 'data' and gathered serves unchanged."""
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(12, 5).astype(np.float32))

    def linear_apply(weight, x):
        return x.reshape(len(x), -1) @ weight

    apply_fn = meshes.sharded_apply(linear_apply, one_process_mesh)
    xs = [rng.randn(3, 4).astype(np.float32) for _ in range(8)]
    with InferenceServer(apply_fn, w, device='cpu', max_batch=8,
                         max_wait_ms=5.0, example_ndim=2) as srv:
        futs = [srv.submit(x) for x in xs]
        ref = linear_apply(w, torch.from_numpy(np.stack(xs))).numpy()
        for f, r in zip(futs, ref):
            np.testing.assert_allclose(f.result(timeout=60), r, rtol=1e-5,
                                       atol=1e-5)


@pytest.fixture(scope='module')
def ranks(trunk, tmp_path_factory):
    """The two workers' results (rank 0's, rank 1's) and their inputs."""
    rng = np.random.RandomState(5)
    torch.manual_seed(5)
    video_state = randomize_port_bn(VideoResNet(num_classes=6, **TRUNK)
                                    ).state_dict()
    msr = MultiScaleRelation(**MSTRN)
    n, d = MSTRN['num_inputs'], MSTRN['in_features']
    inputs = {
        'blocks': _port_stack(trunk), 'x': torch.from_numpy(trunk['x']),
        'video_state': video_state,
        'clips': torch.from_numpy(rng.randn(16, 3, 4, 32, 32)
                                  .astype(np.float32)),
        'experts': stack_block_params([
            {'w1': rng.randn(8, 16).astype(np.float32) * 0.3,
             'w2': rng.randn(16, 8).astype(np.float32) * 0.3}
            for _ in range(4)]),
        'router': torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
        'tokens': torch.from_numpy(rng.randn(64, 8).astype(np.float32)),
        'mstrn_state': msr.state_dict(),
        'frames': torch.from_numpy(rng.randn(3, n, d).astype(np.float32)),
        'serve_w': torch.from_numpy(rng.randn(4, 5).astype(np.float32)),
        'serve_x': torch.from_numpy(rng.randn(7, 4).astype(np.float32))}
    work = tmp_path_factory.mktemp('torch_dist_pipeline')
    torch.save(inputs, work / 'inputs.pt')
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_dist_pipeline_worker.py'),
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
        assert p.returncode == 0 and \
            f'TORCH-DIST-PIPELINE-OK rank={rank}' in out, \
            f'worker {rank} failed:\n{out[-4000:]}'
    return [torch.load(work / f'result_{rank}.pt', weights_only=False)
            for rank in (0, 1)], inputs


def test_two_ranks_hold_half_the_blocks_each(ranks):
    (r0, r1), inputs = ranks
    assert r0['pp']['blocks'] == r1['pp']['blocks'] == 4
    assert r0['pp']['total'] == 8
    with torch.no_grad():
        want = sequential_apply(block_fn, inputs['blocks'], inputs['x'])
    for r in (r0, r1):
        np.testing.assert_allclose(r['pp']['out'].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_two_ranks_gradients_flow_through_the_shift(ranks):
    """Each rank's blocks get the gradient of one process's sequential
    run (rank 0's only through the shift back from rank 1), and the input
    its gradient on both."""
    (r0, r1), inputs = ranks
    stacked = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
               for k, v in inputs['blocks'].items()}
    x = inputs['x'].clone().requires_grad_()
    (sequential_apply(block_fn, stacked, x) ** 2).mean().backward()
    for rank, r in enumerate((r0, r1)):
        for k, v in stacked.items():
            for n, t in v.items():
                want = t.grad[rank * 4:(rank + 1) * 4]
                got = r['pp']['grads'][k][n]
                assert float(got.abs().max()) > 0
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r['pp']['x_grad'].numpy(),
                                   x.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_two_ranks_stage_pipeline_and_data_parallel(ranks):
    (r0, r1), inputs = ranks
    model = VideoResNet(num_classes=6, **TRUNK).eval()
    model.load_state_dict(inputs['video_state'])
    with torch.no_grad():
        want = model(inputs['clips'])
        want_blocks = sequential_apply(block_fn, inputs['blocks'],
                                       inputs['x'])
    for r in (r0, r1):
        np.testing.assert_allclose(r['pp_stages'].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r['dp']['stages'].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r['dp']['out'].numpy(),
                                   want_blocks.numpy(), rtol=1e-5, atol=1e-5)
        for guard in ('guard', 'stages_guard'):
            assert r['dp'][guard] is not None
            assert 'data shards (2)' in r['dp'][guard]


def test_two_ranks_moe_experts_sharded(ranks):
    """E / 2 experts a rank, the output and the router's gradient equal
    one process's, and each rank's experts get their gradient."""
    (r0, r1), inputs = ranks
    experts = {k: v.clone().requires_grad_()
               for k, v in inputs['experts'].items()}
    router = inputs['router'].clone().requires_grad_()
    y, aux, _ = moe.moe_apply(expert_fn, experts, inputs['tokens'], router,
                              capacity_factor=4.0)
    (y.pow(2).mean() + 0.01 * aux).backward()
    for rank, r in enumerate((r0, r1)):
        assert r['moe']['experts'] == 2
        np.testing.assert_allclose(r['moe']['y'].numpy(), y.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r['moe']['router_grad'].numpy(),
                                   router.grad.numpy(), rtol=1e-5, atol=1e-6)
        for k, v in experts.items():
            np.testing.assert_allclose(
                r['moe']['expert_grads'][k].numpy(),
                v.grad[rank * 2:(rank + 1) * 2].numpy(), rtol=1e-5, atol=1e-6)
    assert float(router.grad.abs().sum()) > 0


def test_two_ranks_mstrn_experts_sharded(ranks):
    (r0, r1), inputs = ranks
    msr = MultiScaleRelation(**MSTRN)
    msr.load_state_dict(inputs['mstrn_state'])
    with torch.no_grad():
        want = msr(inputs['frames'][:, None]).reshape(
            len(inputs['frames']), -1)
    for r in (r0, r1):
        assert r['mstrn']['experts'] == 4           # 7 scales + 1 pad, / 2
        np.testing.assert_allclose(r['mstrn']['y'].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_two_ranks_sharded_apply_outside_a_server(ranks):
    """7 rows padded to 8, 4 a rank, gathered and cut back to 7."""
    (r0, r1), inputs = ranks
    want = inputs['serve_x'] @ inputs['serve_w']
    for r in (r0, r1):
        np.testing.assert_allclose(r['serve'].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_and_moe_import_no_jax():
    """In a fresh interpreter the new modules import neither JAX nor the
    JAX package."""
    code = ('import sys; '
            'import pretorched_tpu_torch.parallel.pipeline, '
            'pretorched_tpu_torch.parallel.moe; '
            'bad = [m for m in sys.modules if m == "jax" '
            'or m.startswith(("jax.", "pretorched_tpu.")) '
            'or m == "pretorched_tpu"]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], check=True,
                   cwd=os.path.dirname(HERE), timeout=120)
