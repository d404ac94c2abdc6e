"""Shared factory machinery: construct -> seeded init -> load weights -> stamp.

Counterpart of ``pretorched_tpu/core/factory.py:52-93``: check the class
count against the settings registry, initialize the parameters from
``torch.Generator().manual_seed(seed)`` (where JAX took a PRNG key), load the
hosted ``.pth`` when ``pretrained`` names a dataset, and stamp the metadata
and the input rank (``input_ndim``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.layers import init_parameters
from .wrapper import PretrainedModel


def build_model(name: str, model: PretrainedModel, settings_map,
                num_classes: int, pretrained: Optional[str], *,
                torch_renames: Optional[dict] = None, strict: bool = True,
                background_class_keys=(), check_num_classes: bool = True,
                video: bool = False, seed: int = 0, key_rewrite=None,
                ordered_leaves=None) -> PretrainedModel:
    settings = None
    if pretrained is not None:
        settings = settings_map[name][pretrained]
        if check_num_classes and num_classes != settings['num_classes']:
            raise ValueError(f"num_classes should be {settings['num_classes']}, "
                             f'but is {num_classes}')
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.name = name
    if pretrained is not None:
        from ..zoo import io as zoo_io
        zoo_io.load_pretrained(model, name, pretrained, settings,
                               torch_renames=torch_renames, strict=strict,
                               background_class_keys=background_class_keys,
                               key_rewrite=key_rewrite,
                               ordered_leaves=ordered_leaves)
    model.settings = settings
    # Even with pretrained=None, stamp the registry's default-dataset
    # metadata so preprocessing can always read it (factory.py:77-85).
    meta = settings
    if meta is None:
        ds = settings_map.get(name) or {}
        meta = ds.get('imagenet') or next(iter(ds.values()), None)
    model.stamp_metadata(meta)
    # the batched input's rank: 5 = video (B, C, T, H, W), 4 = image
    # (factory.py:86-89); serving reads it to tell a clip from an image
    model.input_ndim = 5 if video else 4
    return model
