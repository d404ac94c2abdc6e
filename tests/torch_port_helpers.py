"""Shared helpers of the ``test_torch_*`` files: carry a JAX model's
variables into the port, and randomize BN on the JAX side so eval parity
checks every layer (the non-local blocks' output BN is zero-initialized, so
without this the attention never reaches the output)."""

import numpy as np
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
    and shift drawn at random (ranges of ``torch_twins.randomize_bn``)."""
    out = to_numpy_tree(variables)
    _randomize(out['params'], out['batch_stats'], np.random.RandomState(seed))
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
