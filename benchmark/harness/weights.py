"""Seeded weights, made on the device in a few large draws.

Every tensor of the model's state dict is drawn from one generator on the
model's device: one normal draw for all conv and linear weights and one
uniform draw for everything else, each leaf a slice of them, scaled by its
rule. Every batch norm gets its affine and running statistics from the
seed, the non-local output BN (zero at the factory's init, so a fresh
block is the identity) included: with it at zero the attention could not
move a single logit.

Rules, by the kind of module that holds the leaf:

* conv and linear weights: normal with std ``gain * sqrt(2 / fan_in)``;
  ``gain`` is 1 unless the configuration's ``init.gains`` names the leaf
  by its suffix (the non-local theta and phi, whose product is the
  attention's logits, see the configuration's ``assumed``);
* conv and linear biases: uniform in [-0.1, 0.1];
* batch norm: weight U(0.5, 1.5), bias U(-0.2, 0.2), running mean
  U(-0.3, 0.3), running variance U(0.5, 1.5), batches tracked 0.
"""

from __future__ import annotations

import math

import torch

_BN_RANGES = {'weight': (0.5, 1.5), 'bias': (-0.2, 0.2),
              'running_mean': (-0.3, 0.3), 'running_var': (0.5, 1.5)}
_BIAS_RANGE = (-0.1, 0.1)


def _kinds(model):
    """{state-dict key: 'bn' | 'dense'} by the module that holds it."""
    kinds = {}
    for prefix, module in model.named_modules():
        kind = ('bn' if isinstance(module, torch.nn.modules.batchnorm._BatchNorm)
                else 'dense')
        for name, _ in (*module.named_parameters(recurse=False),
                        *module.named_buffers(recurse=False)):
            kinds[f'{prefix}.{name}' if prefix else name] = kind
    return kinds


def _by_suffix(table, key, default):
    return next((v for suffix, v in table.items() if key.endswith(suffix)),
                default)


def seeded_state(model, seed: int, device, gains=None, ranges=None):
    """The state dict ``model`` takes (same keys, shapes and dtypes), drawn
    from ``seed`` on ``device``. ``gains`` and ``ranges`` ({key suffix:
    gain or [low, high]}) replace the rules for the leaves they name."""
    gains, ranges = gains or {}, ranges or {}
    shapes = {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    kinds = _kinds(model)
    normal_keys = [k for k, (shape, _) in shapes.items()
                   if kinds[k] == 'dense' and len(shape) >= 2]
    uniform_keys = [k for k, (_, dtype) in shapes.items()
                    if k not in normal_keys and dtype.is_floating_point]
    g = torch.Generator(device).manual_seed(seed)
    sizes = [math.prod(shapes[k][0]) for k in normal_keys]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    usizes = [math.prod(shapes[k][0]) for k in uniform_keys]
    uniform = torch.rand(sum(usizes), generator=g, device=device)
    out = {}
    for key, part in zip(normal_keys, normal.split(sizes)):
        shape, dtype = shapes[key]
        fan_in = math.prod(shape[1:])
        gain = _by_suffix(gains, key, 1.0)
        out[key] = (part * (gain * math.sqrt(2.0 / fan_in))).view(shape).to(
            dtype)
    for key, part in zip(uniform_keys, uniform.split(usizes)):
        shape, dtype = shapes[key]
        low, high = _by_suffix(ranges, key, _BN_RANGES[key.rsplit('.', 1)[1]]
                               if kinds[key] == 'bn' else _BIAS_RANGE)
        out[key] = (part * (high - low) + low).view(shape).to(dtype)
    for key, (shape, dtype) in shapes.items():
        if key not in out:          # integer buffers: batches tracked
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
    return out
