"""JAX variable tree -> the port's ``state_dict``, in plain numpy.

Counterpart of the export half of ``pretorched_tpu/zoo/convert.py``
(``to_torch_state_dict``, l.242-274). Every JAX model names its leaf modules
with the torch key prefixes, so the mapping is mechanical:

    ('params', 'layer1.0.conv1', 'kernel')  ->  'layer1.0.conv1.weight'
    ('params', 'bn1', 'scale')              ->  'bn1.weight'
    ('batch_stats', 'bn1', 'mean')          ->  'bn1.running_mean'
    ('params', 'attention', 'gamma')        ->  'attention.gamma'

plus the layout transposes (HWIO -> OIHW, THWIO -> OITHW, (in, out) ->
(out, in)) and ``renames`` (port prefix -> checkpoint prefix, exact or a
``^regex``). With ``renames={'last_linear': 'fc'}`` the result is the hosted
checkpoint format, key for key what ``PretrainedModel.export_torch_state_dict``
of the JAX package writes; with no renames it loads straight into the port.
No JAX import: the leaves only need ``np.asarray``.

``inflate_kernel`` is the I3D inflation of the JAX converter
(``pretorched_tpu/zoo/convert.py:93-98``): a 2D conv weight broadcast over
the time axis of a 3D one, without rescaling.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np

_LEAF_TO_TORCH = {
    ('params', 'kernel'): 'weight',
    ('params', 'bias'): 'bias',
    ('params', 'scale'): 'weight',
    ('params', 'embedding'): 'weight',
    ('batch_stats', 'mean'): 'running_mean',
    ('batch_stats', 'var'): 'running_var',
}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def torch_key_for(path: Tuple[str, ...], renames: Optional[dict] = None) -> Optional[str]:
    """Map a flax variable path to its torch state-dict key."""
    collection, leaf = path[0], path[-1]
    # a parameter of a module's own (SAGAN's scalar ``gamma``) keeps its name
    suffix = _LEAF_TO_TORCH.get((collection, leaf),
                                leaf if collection == 'params' else None)
    if suffix is None:
        return None
    prefix = '.'.join(path[1:-1])
    if renames:
        if prefix in renames:
            prefix = renames[prefix]
        else:
            for pat, repl in renames.items():
                if pat.startswith('^'):
                    new = re.sub(pat, repl, prefix)
                    if new != prefix:
                        prefix = new
                        break
    return f'{prefix}.{suffix}' if prefix else suffix


def _to_torch_layout(value: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    if path[-1] == 'kernel':
        if value.ndim == 2:                       # (in, out) -> (out, in)
            return np.transpose(value, (1, 0))
        if value.ndim == 3:                       # (W, in, out) -> (out, in, W)
            return np.transpose(value, (2, 1, 0))
        if value.ndim == 4:                       # HWIO -> OIHW
            return np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 5:                       # THWIO -> OITHW
            return np.transpose(value, (4, 3, 0, 1, 2))
    return value


def inflate_kernel(weight, shape):
    """A 4-D conv weight tensor (O, I, kh, kw) broadcast to the 5-D
    ``shape`` (O, I, kt, kh, kw), each time tap a copy, not rescaled
    (reference: torchvision_models.py:170-191); any other pair of shapes
    comes back unchanged."""
    if weight.dim() != 4 or len(shape) != 5 or \
            tuple(shape[:2]) + tuple(shape[3:]) != tuple(weight.shape):
        return weight
    return weight[:, :, None].expand(*shape).contiguous()


def state_dict_from_flax(variables: Mapping,
                         renames: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """Flax variables ``{'params': ..., 'batch_stats': ...}`` (numpy leaves)
    -> ``{torch_key: np.ndarray}`` in torch layouts. BN prefixes also get the
    ``num_batches_tracked`` scalar that torch's strict load expects; bf16
    leaves widen to float32."""
    sd: Dict[str, np.ndarray] = {}
    bn_prefixes = set()
    for path, leaf in _flatten(variables):
        tkey = torch_key_for(path, renames)
        if tkey is None:
            continue
        value = np.asarray(leaf)
        if value.dtype not in (np.float32, np.float64, np.int32, np.int64):
            value = value.astype(np.float32)
        value = _to_torch_layout(value, path)
        # ascontiguousarray makes a 0-d leaf (gamma) 1-d: keep its shape
        sd[tkey] = np.ascontiguousarray(value).reshape(value.shape)
        if path[0] == 'batch_stats':
            bn_prefixes.add(tkey.rsplit('.', 1)[0] if '.' in tkey else '')
    for tprefix in bn_prefixes:
        key = f'{tprefix}.num_batches_tracked' if tprefix \
            else 'num_batches_tracked'
        sd[key] = np.asarray(0, np.int64)
    return sd


IGNORED_TORCH_SUFFIXES = ('num_batches_tracked',)


def group_state_dict_in_order(state_dict) -> list:
    """A state_dict as ``[(module prefix, {leaf: value}), ...]`` in its
    insertion (registration) order, BN counters left out (the JAX
    converter's ``group_state_dict_in_order``, l.165). For checkpoints
    whose key names are auto-generated graph indices (the reference's
    ResNeXt Lambda-graph ports): there the order of the modules that hold
    parameters is the stable contract."""
    groups, order = {}, []
    for k, v in state_dict.items():
        if k.endswith(IGNORED_TORCH_SUFFIXES):
            continue
        prefix, leaf = k.rsplit('.', 1)
        if prefix not in groups:
            groups[prefix] = {}
            order.append(prefix)
        groups[prefix][leaf] = v
    return [(p, groups[p]) for p in order]


def convert_state_dict_ordered(state_dict, own_state, ordered_leaves) -> dict:
    """Positional conversion (the JAX ``convert_state_dict_ordered``,
    l.187): the port's leaf prefixes ``ordered_leaves``, in the order the
    model creates them, zipped with the checkpoint's modules in
    registration order. ``own_state`` is the model's ``state_dict()``.
    Returns ``{port key: value}`` with the model's own BN counters; raises
    when the counts, a leaf or a shape disagree."""
    torch_groups = group_state_dict_in_order(state_dict)
    if len(torch_groups) != len(ordered_leaves):
        raise ValueError(
            f'leaf count mismatch: checkpoint has {len(torch_groups)} '
            f'param-bearing modules, model has {len(ordered_leaves)}')
    own = {}
    for key, value in own_state.items():
        prefix, leaf = key.rsplit('.', 1)
        own.setdefault(prefix, {})[leaf] = value
    out = {}
    for ours, (tprefix, tgroup) in zip(ordered_leaves, torch_groups):
        if ours not in own:
            # a typo'd entry would otherwise consume a checkpoint module
            raise ValueError(f'ordered leaf {ours!r} matches no model '
                             f'variable (checkpoint module {tprefix!r} would '
                             'be dropped)')
        for leaf, target in own[ours].items():
            if leaf in IGNORED_TORCH_SUFFIXES:
                out[f'{ours}.{leaf}'] = target
                continue
            if leaf not in tgroup:
                raise ValueError(f'{tprefix} has no {leaf} for {ours}')
            value = tgroup[leaf]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f'shape mismatch {tprefix} -> {ours}.{leaf}: '
                                 f'{tuple(value.shape)} vs '
                                 f'{tuple(target.shape)}')
            out[f'{ours}.{leaf}'] = value
    return out


_DENSENET_OLD_KEY = re.compile(
    r'^(.*denselayer\d+\.(?:norm|relu|conv))\.'
    r'((?:[12])\.(?:weight|bias|running_mean|running_var))$')


def densenet_key_rewrite(key: str) -> str:
    """Old densenet checkpoints' dotted keys (``denselayer1.norm.1.weight``)
    -> the current ones (``denselayer1.norm1.weight``) (reference:
    torchvision_models.py:288-297)."""
    m = _DENSENET_OLD_KEY.match(key)
    return m.group(1) + m.group(2) if m else key
