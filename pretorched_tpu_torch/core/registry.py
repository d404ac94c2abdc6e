"""Model registry and pretrained-settings aggregation.

A copy of ``pretorched_tpu/core/registry.py`` (which has no JAX import, but
importing it through ``pretorched_tpu`` imports JAX):

* ``pretrained_settings``: ``{model_name: {dataset: settings_dict}}`` with the
  exact metadata keys of the reference (url/input_space/input_size/input_range/
  mean/std/num_classes, plus optional ``scale``).
* ``model_names``: the list of registered names (the reference aggregates only
  16 families there; we mirror that via ``in_settings_registry``).
* factory lookup: ``pretorched_tpu_torch.__dict__[name](num_classes, pretrained=...)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

# name -> factory(num_classes=..., pretrained=...) -> PretrainedModel
MODEL_REGISTRY: Dict[str, Callable] = {}

# Aggregated mirror of the reference's settings.py registry.
pretrained_settings: Dict[str, Dict[str, dict]] = {}
model_names: List[str] = []


def image_settings(url: str, *, input_size=(3, 224, 224), input_space='RGB',
                   input_range=(0, 1), mean=(0.485, 0.456, 0.406),
                   std=(0.229, 0.224, 0.225), num_classes=1000, **extra) -> dict:
    """Build a settings dict with the reference's metadata schema."""
    d = {
        'url': url,
        'input_space': input_space,
        'input_size': list(input_size),
        'input_range': list(input_range),
        'mean': list(mean),
        'std': list(std),
        'num_classes': num_classes,
    }
    d.update(extra)
    return d


def register_settings(settings: Dict[str, Dict[str, dict]],
                      in_settings_registry: bool = True) -> None:
    """Merge a per-file settings dict into the global registry.

    ``in_settings_registry=False`` mirrors reference families that exist as
    factories but are absent from settings.py's aggregation (SURVEY §2.6).
    """
    for name, per_dataset in settings.items():
        if in_settings_registry:
            pretrained_settings[name] = per_dataset
            if name not in model_names:
                model_names.append(name)


def register_model(fn: Callable = None, *, name: Optional[str] = None):
    """Decorator registering a factory under its function name."""
    def wrap(f):
        MODEL_REGISTRY[name or f.__name__] = f
        return f
    if fn is not None:
        return wrap(fn)
    return wrap


def get_factory(name: str) -> Callable:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f'Unknown model {name!r}. Available: {sorted(MODEL_REGISTRY)}') from None
