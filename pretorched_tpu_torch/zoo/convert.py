"""JAX variable tree -> the port's ``state_dict``, in plain numpy.

Counterpart of the export half of ``pretorched_tpu/zoo/convert.py``
(``to_torch_state_dict``, l.242-274). Every JAX model names its leaf modules
with the torch key prefixes, so the mapping is mechanical:

    ('params', 'layer1.0.conv1', 'kernel')  ->  'layer1.0.conv1.weight'
    ('params', 'bn1', 'scale')              ->  'bn1.weight'
    ('batch_stats', 'bn1', 'mean')          ->  'bn1.running_mean'

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
    suffix = _LEAF_TO_TORCH.get((collection, leaf))
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
        sd[tkey] = np.ascontiguousarray(_to_torch_layout(value, path))
        if path[0] == 'batch_stats':
            bn_prefixes.add(tkey.rsplit('.', 1)[0] if '.' in tkey else '')
    for tprefix in bn_prefixes:
        key = f'{tprefix}.num_batches_tracked' if tprefix \
            else 'num_batches_tracked'
        sd[key] = np.asarray(0, np.int64)
    return sd
