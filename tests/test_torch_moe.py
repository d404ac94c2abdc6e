"""The port's expert parallelism (``parallel/moe.py``) against the JAX
package, on the CPU.

The twins of ``tests/test_moe_expert_parallel.py``. Experts are 2-layer
GELU MLPs whose parameters (numpy, seeded) go to both packages, to the
port through ``stack_block_params``; tokens and routers are seeded too.

* ``moe_apply`` against the port's per-token ``moe_reference`` and JAX's
  ``moe_apply``: with room for every token, and with a skewed router at
  capacity factor 1.0, where the dropped tokens are equal zero rows;
* its gradients (router and experts) against JAX's, the router's nonzero;
* the mesh path on an 'expert' axis of one process (a one-process Gloo
  group made here and destroyed after) against the in-process result; the
  two-rank run, E / 2 experts a rank, is read in
  ``tests/test_torch_pipeline.py``;
* the aux loss at uniform routing, dispatch slots within capacity, ties
  to the first expert;
* ``mstrn_expert_apply`` against JAX's dense ``MultiScaleRelation`` (its
  flax parameters carried into the port's module), and
  ``trn_expert_forward`` on ``trn(arch='resnet18', num_segments=4)``
  against JAX's ``model.module.apply``; the precomputed stack gives the
  same output bit for bit.

Tolerances: 1e-5 for the MoE against the oracle and JAX's (f32 sums in
another order), 2e-4 for the MSTRN head (a block) and 2e-3 for the whole
TRN against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu.models.trn import MultiScaleRelation as JaxMSR
from pretorched_tpu.parallel import moe as jax_moe
from pretorched_tpu.parallel import pipeline as jax_pp
from pretorched_tpu_torch.models.trn import MultiScaleRelation
from pretorched_tpu_torch.parallel import mesh as meshes
from pretorched_tpu_torch.parallel.moe import (aux_load_balancing_loss,
                                               moe_apply, moe_dispatch,
                                               moe_reference,
                                               mstrn_expert_apply,
                                               mstrn_expert_params,
                                               mstrn_expert_spec,
                                               trn_expert_forward)
from pretorched_tpu_torch.parallel.pipeline import stack_block_params

from torch_port_helpers import port_state_dict, randomize_bn, to_nt
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

E, D, H, T = 4, 8, 16, 32


def _problem(seed, skew=0.0, tokens=T):
    rng = np.random.RandomState(seed)
    experts = [{'w1': rng.randn(D, H).astype(np.float32) * 0.3,
                'w2': rng.randn(H, D).astype(np.float32) * 0.3}
               for _ in range(E)]
    router = rng.randn(D, E).astype(np.float32)
    router[:, 0] += skew
    return experts, router, rng.randn(tokens, D).astype(np.float32)


def _expert_fn(p, x):
    return F.gelu(x @ p['w1'], approximate='tanh') @ p['w2']


def _jax_expert_fn(p, x):
    return jax.nn.gelu(x @ p['w1']) @ p['w2']


def _jax_moe(experts, router, x, factor):
    return jax_moe.moe_apply(_jax_expert_fn,
                             jax_pp.stack_block_params(experts),
                             jnp.asarray(x), jnp.asarray(router),
                             capacity_factor=factor)


@pytest.mark.parametrize('skew,factor', [(0.0, 4.0), (2.0, 1.0)])
def test_moe_matches_per_token_oracle_and_jax(skew, factor):
    experts, router, x = _problem(0, skew)
    stacked = stack_block_params(experts)
    y, aux, metrics = moe_apply(_expert_fn, stacked, torch.from_numpy(x),
                                torch.from_numpy(router),
                                capacity_factor=factor)
    ref = moe_reference(_expert_fn, stacked, torch.from_numpy(x),
                        torch.from_numpy(router), capacity_factor=factor)
    jy, jaux, jmetrics = _jax_moe(experts, router, x, factor)
    y = y.detach().numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    dropped = float(metrics['fraction_dropped'])
    assert dropped == pytest.approx(float(jmetrics['fraction_dropped']))
    assert metrics['capacity'] == jmetrics['capacity']
    assert np.isfinite(float(aux)) and float(aux) >= 1.0   # Cauchy-Schwarz
    if skew:
        assert dropped > 0.0
        rows = np.all(ref == 0, axis=-1)
        assert rows.any()
        np.testing.assert_array_equal(np.all(y == 0, axis=-1), rows)
    else:
        assert dropped == 0.0


def test_moe_gradients_match_jax():
    experts, router, x = _problem(1)
    stacked = {k: v.requires_grad_()
               for k, v in stack_block_params(experts).items()}
    rw = torch.from_numpy(router).requires_grad_()
    y, aux, _ = moe_apply(_expert_fn, stacked, torch.from_numpy(x), rw,
                          capacity_factor=4.0)
    (y.pow(2).mean() + 0.01 * aux).backward()

    def loss(params, r):
        jy, jaux, _ = jax_moe.moe_apply(_jax_expert_fn, params,
                                        jnp.asarray(x), r,
                                        capacity_factor=4.0)
        return jnp.mean(jy ** 2) + 0.01 * jaux

    jstacked = jax_pp.stack_block_params(experts)
    g_p, g_r = jax.grad(loss, argnums=(0, 1))(jstacked, jnp.asarray(router))
    for k in ('w1', 'w2'):
        np.testing.assert_allclose(stacked[k].grad.numpy(),
                                   np.asarray(g_p[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rw.grad.numpy(), np.asarray(g_r), rtol=1e-5,
                               atol=1e-6)
    assert float(rw.grad.abs().sum()) > 0   # through the gate and aux


@pytest.fixture(scope='module')
def expert_mesh():
    """A ('data', 'expert') mesh of this process alone (Gloo)."""
    mesh = meshes.make_mesh((1, 1), ('data', 'expert'), device_type='cpu')
    yield mesh
    torch.distributed.destroy_process_group()


def test_moe_mesh_path_at_world_size_one(expert_mesh):
    experts, router, x = _problem(2, tokens=64)
    stacked = stack_block_params(experts)
    args = (_expert_fn, stacked, torch.from_numpy(x),
            torch.from_numpy(router))
    y, aux, _ = moe_apply(*args, expert_mesh, capacity_factor=4.0)
    want, want_aux, _ = moe_apply(*args, capacity_factor=4.0)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)


def test_aux_loss_uniform_routing_is_one():
    onehot = F.one_hot(torch.arange(T) % E, E).float()
    metrics = {'router_probs': torch.softmax(torch.zeros(T, E), -1),
               'expert_onehot': onehot}
    assert abs(float(aux_load_balancing_loss(metrics)) - 1.0) < 1e-6


def test_dispatch_positions_respect_capacity():
    # 6 tokens all to expert 0, capacity 2 -> exactly 2 kept at slots 0, 1
    logits = torch.tensor([[5.0, 0.0]]).repeat(6, 1)
    dispatch, combine, _ = moe_dispatch(logits, capacity=2)
    np.testing.assert_array_equal(dispatch.sum((1, 2)).numpy(),
                                  [1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(dispatch[:2, 0].argmax(-1).numpy(), [0, 1])
    # a tie goes to the first expert, as jnp.argmax sends it
    tie, _, _ = moe_dispatch(torch.zeros(3, 4), capacity=3)
    want, _, _ = jax_moe.moe_dispatch(jnp.zeros((3, 4)), capacity=3)
    np.testing.assert_array_equal(tie.numpy(), np.asarray(want))


def test_mstrn_expert_apply_matches_jax_dense_module():
    """8 segments: 7 live scale-experts padded to 8, the port's module
    holding the JAX module's flax parameters."""
    n, d, out, bott, B = 8, 24, 12, 16, 3
    module = JaxMSR(num_inputs=n, in_features=d, out_features=out,
                    bottleneck_dim=bott)
    feats = np.random.RandomState(3).randn(B, 1, n, d).astype(np.float32)
    variables = jax.jit(module.init)(jax.random.key(0), feats)
    want = np.asarray(module.apply(variables, feats)).reshape(B, out)
    msr = MultiScaleRelation(n, d, out, bott)
    msr.load_state_dict(port_state_dict(variables), strict=True)
    spec = mstrn_expert_spec(n, pad_experts_to=8)
    assert spec['E'] == 8 and len(spec['scales']) == 7
    stacked = mstrn_expert_params(msr, spec)
    jstacked = jax_moe.mstrn_expert_params(variables['params'], spec)
    for k, v in stacked.items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      np.asarray(jstacked[k]))
    with torch.no_grad():
        y = mstrn_expert_apply(stacked, spec,
                               torch.from_numpy(feats.reshape(B, n, d)))
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope='module')
def trn_pair():
    """``trn(arch='resnet18', num_segments=4)`` with MSTRN in both packages
    (every BN randomized), the port's carrying the JAX one's weights."""
    kw = dict(num_classes=11, num_segments=4, consensus='MSTRN',
              arch='resnet18', pretrained=None, frame_bottleneck_dim=32,
              video_feature_dim=16)
    jmodel = pretorched_tpu.trn(**kw).eval()
    jmodel.variables = randomize_bn(jmodel.variables, seed=5)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.variables)
    del variables['params']['base_module']['last_linear']
    model = pretorched_tpu_torch.trn(**kw).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    clips = np.random.RandomState(4).randn(2, 3, 4, 64, 64).astype(np.float32)
    return jmodel, model, clips


def test_trn_expert_forward_matches_jax(trn_pair):
    jmodel, model, clips = trn_pair
    want = np.asarray(jax.jit(jmodel.module.apply)(jmodel.variables,
                                                   to_nt(clips)))
    fwd, spec = trn_expert_forward(model)
    assert spec['E'] == 3 and len(spec['scales']) == 3
    with torch.no_grad():
        got = fwd(torch.from_numpy(clips)).numpy()
        dense = model(torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='MSTRN'):
        trn_expert_forward(pretorched_tpu_torch.trn(
            num_classes=3, num_segments=4, consensus='TRN', arch='resnet18'))


def test_trn_expert_forward_precomputed_stack(trn_pair):
    _, model, clips = trn_pair
    fwd, spec = trn_expert_forward(model)
    x = torch.from_numpy(clips)
    with torch.no_grad():
        stacked = mstrn_expert_params(model.temporal_relation, spec)
        assert torch.equal(fwd(x), fwd(x, stacked))
