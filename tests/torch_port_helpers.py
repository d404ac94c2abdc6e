"""Shared helpers of the ``test_torch_*`` files: carry a JAX model's
variables into the port, and randomize BN on the JAX side so eval parity
checks every layer (the non-local blocks' output BN is zero-initialized, so
without this the attention never reaches the output)."""

import numpy as np
import pytest
import torch

import pretorched_tpu
import pretorched_tpu_torch
from pretorched_tpu_torch.zoo.convert import state_dict_from_flax


def _randomize(params, stats, rng):
    if 'mean' in stats and 'var' in stats:
        stats['mean'] = rng.uniform(-0.3, 0.3, np.shape(stats['mean'])).astype(np.float32)
        stats['var'] = rng.uniform(0.5, 1.5, np.shape(stats['var'])).astype(np.float32)
        params['scale'] = rng.uniform(0.5, 1.5, np.shape(params['scale'])).astype(np.float32)
        params['bias'] = rng.uniform(-0.2, 0.2, np.shape(params['bias'])).astype(np.float32)
        return
    for name in sorted(stats):
        _randomize(params[name], stats[name], rng)


def to_numpy_tree(tree):
    if hasattr(tree, 'items'):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def randomize_bn(variables, seed=0):
    """Numpy copy of flax ``variables`` with every BN's running stats, scale
    and shift drawn at random (ranges of ``torch_twins.randomize_bn``); a
    model without BN comes back as it was."""
    out = to_numpy_tree(variables)
    _randomize(out['params'], out.get('batch_stats', {}),
               np.random.RandomState(seed))
    return out


def port_state_dict(variables, renames=None):
    return {k: torch.from_numpy(np.array(v))
            for k, v in state_dict_from_flax(variables, renames).items()}


def to_nt(x):
    """Channels-first numpy -> channels-last (what flax modules take)."""
    return np.moveaxis(x, 1, -1)


def carry_model(name, x, num_classes=10):
    """The JAX model ``name`` with BN randomized, and the port's model with
    the same weights (strict load). Returns (jax_model, port_model,
    jax_logits_on_x)."""
    jmodel = pretorched_tpu.__dict__[name](num_classes=num_classes,
                                           pretrained=None)
    jmodel.variables = randomize_bn(jmodel.variables)
    want = np.asarray(jmodel(x))
    model = pretorched_tpu_torch.__dict__[name](num_classes=num_classes,
                                                pretrained=None).eval()
    model.load_state_dict(port_state_dict(jmodel.variables), strict=True)
    return jmodel, model, want


def assert_state_matches(model, final, initial, tol=5e-2):
    """Each tensor's change over the steps agrees within ``tol`` of the
    JAX change's largest element (1e-6 at least: the biases that feed a BN
    or a softmax have no gradient, and move by weight decay alone)."""
    want, start = port_state_dict(final), port_state_dict(initial)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key.endswith('num_batches_tracked'):
            continue
        moved = (w - start[key]).double().numpy()
        scale = max(float(np.abs(moved).max()), 1e-6)
        np.testing.assert_allclose(
            (got[key].double() - start[key].double()).numpy(), moved, rtol=0,
            atol=tol * scale, err_msg=key)


def randomize_port_bn(model, seed=0):
    """Every BN of a port model with its running stats, scale and shift
    drawn at random (the ranges of ``randomize_bn``), in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return model


def jax_variables_from_port(module, state_dict, input_shape,
                            init_kwargs=None, **convert_kw):
    """Flax variables of ``module`` (built on a template from
    ``jax.eval_shape``, so nothing is compiled) holding the port's
    ``state_dict``, through the JAX package's own converter.
    ``init_kwargs`` go to ``module.init`` (``train=True`` builds
    Inception-v3's aux head)."""
    import jax

    from pretorched_tpu.zoo.convert import convert_state_dict
    key = jax.random.key(0)
    shapes = jax.eval_shape(
        lambda x: module.init({'params': key, 'dropout': key}, x,
                              **(init_kwargs or {})),
        jax.ShapeDtypeStruct(input_shape, np.float32))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    # copies: JAX may read a numpy buffer when its asynchronous dispatch
    # runs, after a train-mode torch forward has moved the BN statistics
    sd = {k: v.detach().numpy().copy() for k, v in state_dict.items()}
    return convert_state_dict(sd, template, **convert_kw)


def zeros_init(module, input_shape, seed=0, **call_kwargs):
    """A stand-in for the JAX factories' ``core.factory.init_variables``:
    zeros on a ``jax.eval_shape`` template, nothing compiled. For a JAX
    factory whose every variable a hosted file then overwrites."""
    import jax

    shapes = jax.eval_shape(
        lambda x: module.init({'params': jax.random.key(seed),
                               'dropout': jax.random.key(seed)}, x,
                              **call_kwargs),
        jax.ShapeDtypeStruct(input_shape, np.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))


def run_jax(fn, *args):
    """``fn(*args)`` jitted at XLA's backend optimization level 0: a parity
    test runs each program once, so compiling is most of its cost, and
    level 0 compiles faster (PolyNet's features: a fifth less)."""
    import jax

    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


def features_and_head(model, jmodule, size, head, template_size=None,
                      seed=0, init_kwargs=None, **convert_kw):
    """A net with a fixed head pool, held against the JAX module on the
    same weights (the port's seeded init, every BN randomized) in two
    pieces: ``features`` of a ``size`` px image (full depth and width, at
    a size that keeps the full size's odd / even steps), and ``logits`` of
    a seeded feature map ``head`` x ``head``, the head pool's own size.
    The JAX module runs jitted (``run_jax``; op by op it compiles every
    distinct conv shape, several times slower for these nets), its
    variables on a ``template_size`` template (default ``size``).
    Returns ((port
    features, JAX features), (port logits, JAX logits)) as numpy."""
    randomize_port_bn(model, seed=seed).eval()
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 3, size, size).astype(np.float32)
    t = template_size or size
    variables = jax_variables_from_port(jmodule, model.state_dict(),
                                        (1, t, t, 3), init_kwargs,
                                        **convert_kw)
    want_f = np.moveaxis(np.asarray(run_jax(
        lambda v, x: jmodule.apply(v, x, mode='features'), variables,
        to_nt(x))), -1, 1)
    fmap = rng.randn(1, model.num_features, head, head).astype(np.float32)
    want_l = np.asarray(run_jax(
        lambda v, x: jmodule.apply(v, x, mode='logits'), variables,
        to_nt(fmap)))
    with torch.no_grad():
        got_f = model.features(torch.from_numpy(x)).numpy()
        got_l = model.logits(torch.from_numpy(fmap)).numpy()
    return (got_f, want_f), (got_l, want_l)


def assert_near(got, want, tol):
    """Elementwise within ``tol``, relative, and absolute in units of
    ``max |want|`` where that is below 1: never looser than the round's
    ``rtol = atol = tol``, and as tight for a net whose outputs are small."""
    scale = min(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def assert_metadata_like_jax(model, name):
    """``model``, built with ``pretrained=None``, carries the metadata the
    JAX factory stamps then: its module's settings for ``imagenet``, else
    its first dataset's (``pretorched_tpu/core/factory.py:77-85``)."""
    import importlib

    factory = pretorched_tpu_torch.MODEL_REGISTRY[name]
    jmod = importlib.import_module(factory.__module__.replace(
        'pretorched_tpu_torch', 'pretorched_tpu'))
    per_dataset = jmod.pretrained_settings[name]
    meta = per_dataset.get('imagenet') or next(iter(per_dataset.values()))
    for key in ('input_space', 'input_size', 'input_range', 'mean', 'std'):
        assert getattr(model, key) == meta[key], (name, key)
    assert getattr(model, 'scale', None) == meta.get('scale'), name


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the test on one torch thread. The suite runs several workers on
    a few cores, and torch's default of a thread a core oversubscribes
    them: small ops then wait on each other (10x slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
