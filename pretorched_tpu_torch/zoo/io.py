"""Weight cache and the hosted-checkpoint load path.

Counterpart of ``pretorched_tpu/zoo/io.py``. Checkpoints live in a local
cache directory (``$PRETORCHED_HOME``, then ``$TORCH_MODEL_ZOO``, then
``~/.cache/pretorched_tpu``). A hosted file is a ``.pth``, a hickle / HDF5
export (``.hkl``, ``.h5``, ``.hdf5``: the WRN-50-2 export; read with
``h5py``, imported only then) or an ``.npz``. It already is the port's
format, so it loads straight into the module: the ``{'state_dict': ...}``
wrapper and DataParallel's ``module.`` prefix are stripped, checkpoint
prefixes are renamed to the port's (``fc`` -> ``last_linear``), a 2D conv
weight meeting a 3D parameter is inflated over time (``resneti3d50`` loads
a 2D ``resnet50`` checkpoint), the tensors under a prefix of
``background_class_keys`` lose their first row (the TF ports' extra
background class, which the JAX converter slices off,
``pretorched_tpu/zoo/convert.py:143-144``), and ``load_state_dict`` runs
with the factory's ``strict`` flag. Densenet's old dotted keys are
rewritten first (``key_rewrite``), and ResNeXt's Lambda-graph files, whose
keys are auto-indices, load by position (``ordered_leaves``). There is no
converted cache.

Offline behaviour: with no hosted file found, the model keeps its seeded random
init with a warning, or raises when ``PRETORCHED_STRICT_WEIGHTS`` is set.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .convert import convert_state_dict_ordered, inflate_kernel


def cache_dir() -> Path:
    for env in ('PRETORCHED_HOME', 'TORCH_MODEL_ZOO'):
        v = os.environ.get(env)
        if v:
            return Path(v)
    return Path.home() / '.cache' / 'pretorched_tpu'


def find_torch_checkpoint(url: str) -> Optional[Path]:
    fname = (url or '').rstrip('/').rsplit('/', 1)[-1]
    if not fname:
        return None     # settings with url=None (no hosted checkpoint)
    for base in (cache_dir() / 'weights', cache_dir(),
                 Path.home() / '.torch' / 'models'):
        p = base / fname
        if p.exists():
            return p
    return None


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """Checkpoint file -> {key: tensor}, by its suffix, as the JAX loader
    reads them (``pretorched_tpu/zoo/io.py:50-95``):

    * ``.hkl`` / ``.h5`` / ``.hdf5``: every numeric dataset of the HDF5
      tree (``_load_h5_state_dict``); needs ``h5py``;
    * ``.npz``: every array, under its own name;
    * anything else is a ``.pth``: ``{'state_dict': ...}`` unwrapped and
      DataParallel ``module.`` prefixes stripped. Tensors only
      (``weights_only=True``): a checkpoint is data, not code."""
    suffix = Path(path).suffix.lower()
    if suffix in ('.hkl', '.h5', '.hdf5'):
        return _load_h5_state_dict(path)
    if suffix == '.npz':
        with np.load(str(path)) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    obj = torch.load(str(path), map_location='cpu', weights_only=True)
    if isinstance(obj, dict) and 'state_dict' in obj:
        obj = obj['state_dict']
    return {(k[len('module.'):] if k.startswith('module.') else k): v
            for k, v in obj.items()}


def _load_h5_state_dict(path) -> Dict[str, torch.Tensor]:
    """Every numeric dataset of an HDF5 / hickle file as {key: tensor}.
    hickle versions lay the dict out differently (datasets at the root, or
    under a ``data`` group), so the whole tree is walked, hickle's
    ``data/`` or ``data.`` wrapper stripped and the path joined with
    ``.``."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f'reading {path} needs the h5py package, which is '
                          'not installed') from e
    out = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        value = np.asarray(obj)
        if value.dtype.kind not in 'biuf':      # hickle's type strings
            return
        for wrapper in ('data/', 'data.'):
            if name.startswith(wrapper):
                name = name[len(wrapper):]
        out[name.replace('/', '.')] = torch.from_numpy(np.array(value))

    with h5py.File(str(path), 'r') as f:
        f.visititems(visit)
    return out


def _rename(key: str, inverse: Dict[str, str]) -> str:
    for ckpt_prefix, port_prefix in inverse.items():
        if key.startswith(ckpt_prefix + '.'):
            return port_prefix + key[len(ckpt_prefix):]
    return key


def load_state_dict_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                         *, torch_renames: Optional[dict] = None,
                         strict: bool = True, background_class_keys=(),
                         key_rewrite: Optional[Callable[[str], str]] = None):
    """Load a checkpoint-format state_dict into ``model``.

    ``key_rewrite`` first rewrites each checkpoint key (densenet's old
    dotted keys). ``torch_renames`` maps port prefixes to checkpoint
    prefixes (as the JAX factories pass them, ``{'last_linear': 'fc'}``). The tensors under a
    port prefix of ``background_class_keys`` drop their first row (the
    background class). With ``strict=False``,
    keys the model lacks, keys the checkpoint lacks and tensors of the wrong
    shape are skipped, and the warning names every one. Returns the
    ``(missing_keys, unexpected_keys)`` of ``load_state_dict``, with
    mismatched shapes counted as unexpected."""
    if key_rewrite is not None:
        sd = {key_rewrite(k): v for k, v in sd.items()}
    inverse = {v: k for k, v in (torch_renames or {}).items()}
    own = model.state_dict()
    sd = {k: inflate_kernel(v, own[k].shape) if k in own else v
          for k, v in ((_rename(k, inverse), v) for k, v in sd.items())}
    for k in sd:
        if k.rsplit('.', 1)[0] in background_class_keys:
            sd[k] = sd[k][1:]
    mismatched = sorted(k for k, v in sd.items()
                        if k in own and tuple(v.shape) != tuple(own[k].shape))
    if mismatched and strict:
        raise ValueError('shape mismatch: ' + ', '.join(
            f'{k} {tuple(sd[k].shape)} vs {tuple(own[k].shape)}'
            for k in mismatched))
    for k in mismatched:
        del sd[k]
    result = model.load_state_dict(sd, strict=strict)
    missing = list(result.missing_keys)
    unexpected = sorted(list(result.unexpected_keys) + mismatched)
    if missing or unexpected:
        warnings.warn(f'{getattr(model, "name", None)}: non-strict load kept '
                      f'the init for missing={missing} and dropped '
                      f'unexpected={unexpected}')
    return missing, unexpected


def load_pretrained(model, name: str, dataset: str, settings: dict, *,
                    torch_renames: Optional[dict] = None, strict: bool = True,
                    background_class_keys=(),
                    key_rewrite: Optional[Callable[[str], str]] = None,
                    ordered_leaves: Optional[list] = None):
    """Find the hosted file for (name, dataset) and load it into
    ``model``; returns ``(missing, unexpected)`` or None when no file was
    found. With ``ordered_leaves`` (ResNeXt's Lambda-graph files, whose
    keys are auto-indices) the file's modules are matched to the port's by
    position (``convert.convert_state_dict_ordered``), as the JAX
    ``load_pretrained_variables`` does."""
    tpath = find_torch_checkpoint(settings.get('url', '') or '')
    if tpath is None:
        msg = (f'pretrained weights for {name}/{dataset} not found locally '
               f"(the file from {settings.get('url')!r} under "
               f'{cache_dir()}/weights). Proceeding with random initialization.')
        if os.environ.get('PRETORCHED_STRICT_WEIGHTS'):
            raise FileNotFoundError(msg)
        warnings.warn(msg)
        return None
    sd = load_torch_state_dict(tpath)
    if ordered_leaves is not None:
        sd = convert_state_dict_ordered(sd, model.state_dict(), ordered_leaves)
    return load_state_dict_into(model, sd, torch_renames=torch_renames,
                                strict=strict,
                                background_class_keys=background_class_keys,
                                key_rewrite=key_rewrite)
