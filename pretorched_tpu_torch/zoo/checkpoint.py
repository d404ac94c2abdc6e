"""Training checkpoint save and resume.

Counterpart of ``pretorched_tpu/zoo/checkpoint.py``, with the reference's
mechanism (examples/imagenet_eval.py:78-88, 256-259): ``torch.save`` of a
dict (model, optimizer and scheduler state dicts, step counters) and a
``model_best`` copy. A save writes a temporary file and renames it over the
target, so an interrupted save leaves the last good checkpoint in place.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import torch


def save_checkpoint(path: str, state: Dict[str, Any], is_best: bool = False,
                    best_name: str = 'model_best.pth') -> None:
    """Write ``state`` to ``path``; with ``is_best``, copy it to
    ``best_name`` beside it."""
    tmp = f'{path}.tmp'
    torch.save(state, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, os.path.join(
            os.path.dirname(os.path.abspath(path)), best_name))


def load_checkpoint(path: str, map_location='cpu') -> Dict[str, Any]:
    """The dict ``save_checkpoint`` wrote; tensors onto ``map_location``.
    Restore with each object's ``load_state_dict``."""
    return torch.load(path, map_location=map_location, weights_only=True)
