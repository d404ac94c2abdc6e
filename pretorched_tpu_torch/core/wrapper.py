"""PretrainedModel — the public model object of the port.

Counterpart of ``pretorched_tpu/core/wrapper.py`` with the reference's
contract (README.md:413-547, torchvision_models.py:443-481): ``model(x)``,
``model.features(x)``, ``model.logits(f)``, ``model.last_linear`` (which
``Identity()`` may replace), and the stamped metadata attributes
``input_space/input_size/input_range/mean/std``.

Here the model IS an ``nn.Module``: a family subclasses ``PretrainedModel``
and implements ``_features`` and ``_logits`` on channels-first tensors.
``bfloat16()`` keeps the JAX package's meaning (compute in bf16, params stay
f32, wrapper.py:221-225) through ``torch.autocast`` around each call, not
torch's (which would cast the parameters).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from ..models.layers import torch_conv_init


class PretrainedModel(nn.Module):
    """Base class of every model the factories return."""

    def __init__(self, num_classes: int, num_features: int):
        super().__init__()
        self.name: Optional[str] = None
        self.settings: Optional[dict] = None     # the loaded dataset's, or None
        # what stamp_metadata stamped: the loaded dataset's settings, else
        # the registry's default dataset's (what preprocessing reads)
        self.metadata: Optional[dict] = None
        self.num_classes = num_classes
        self.num_features = num_features
        self.compute_dtype: Optional[torch.dtype] = None
        self.last_linear = nn.Linear(num_features, num_classes)

    # ----------------------------------------------------------- subclasses
    def _features(self, x):
        raise NotImplementedError

    def _logits(self, features):
        raise NotImplementedError

    # --------------------------------------------------------------- public
    def _autocast(self, x):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=self.compute_dtype)

    def features(self, x):
        """Backbone features, channels-first like the reference."""
        with self._autocast(x):
            return self._features(x)

    def logits(self, features):
        with self._autocast(features):
            return self._logits(features)

    def forward(self, x):
        with self._autocast(x):
            return self._logits(self._features(x))

    def _set_compute_dtype(self, dtype):
        """On this model and every model nested in it (TRN's backbone), as
        the JAX wrapper's ``_replace_dtype`` recurses (wrapper.py:32-53)."""
        for m in self.modules():
            if isinstance(m, PretrainedModel):
                m.compute_dtype = dtype

    def bfloat16(self):
        """Compute in bfloat16; parameters stay float32."""
        self._set_compute_dtype(torch.bfloat16)
        return self

    def float(self):
        self._set_compute_dtype(None)
        return super().float()

    @torch.no_grad()
    def reset_classifier(self, num_classes: int,
                         generator: Optional[torch.Generator] = None):
        """Re-initialize ``last_linear`` for a new class count (fine-tuning),
        on the device of the model's parameters: weight uniform in
        +-1/sqrt(fan_in), bias zero (``pretorched_tpu/core/wrapper.py:187-197``)."""
        generator = generator or torch.Generator().manual_seed(0)
        head = nn.Linear(self.num_features, num_classes)
        torch_conv_init(head.weight, head.bias, generator)
        self.last_linear = head.to(next(self.parameters()).device)
        self.num_classes = num_classes

    def stamp_metadata(self, meta: Optional[dict]) -> None:
        if meta is None:
            return
        self.metadata = meta
        self.input_space = meta['input_space']
        self.input_size = meta['input_size']
        self.input_range = meta['input_range']
        self.mean = meta['mean']
        self.std = meta['std']
        if 'scale' in meta:
            self.scale = meta['scale']
