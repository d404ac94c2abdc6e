"""Ahead-of-time model export for serving, through ``torch.export``.

Counterpart of ``pretorched_tpu/zoo/export.py``, which serializes a jitted
forward as StableHLO with a params sidecar. Here the artifact is one
``torch.export.save`` file (``.pt2``): the traced program with its weights
in it, reloadable in a process that builds no model. Deliberate departures
from the JAX module:

* ``input_shape`` is channels-first (the port's layout), e.g. ``(3, 16,
  224, 224)`` for a 16-frame clip; JAX's is channels-last;
* the program is traced on one device (``device``) instead of for a list
  of platforms;
* ``exported_program_text`` takes the place of ``stablehlo_text``: PyTorch
  has no StableHLO, and the text is the exported program's graph.

The kernels of the port are registered operators (``ops/library.py``), so
an exported non-local or fused SlowFast model records
``pretorched.nonlocal_attention_fwd`` and ``pretorched.fused_bottleneck_tail``
as nodes: on the card the reloaded program launches the kernels, on the CPU
it runs their plain versions. A model in bf16 (``model.bfloat16()``)
computes under ``torch.autocast``, which the trace keeps as an autocast
region around the forward: the program computes in bf16 and its weights
stay f32, as in eager.

Symbolic batch: ``batch='b'`` exports with a symbolic leading dimension
(``torch.export.Dim``, 1 to ``MAX_BATCH``), so one artifact serves any
batch size; a digit string pins it, and None means 1.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import torch

from .. import ops  # noqa: F401  (registers the kernels' operators)

MODES = ('forward', 'features', 'logits')
MAX_BATCH = 65535


class _Mode(torch.nn.Module):
    """``model``'s ``forward``, ``features`` or ``logits`` as a forward
    (the JAX ``module.apply(mode=...)``); the parameter names stay the
    model's, under ``model.``."""

    def __init__(self, model, mode):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f'mode {mode!r} is none of {MODES}')
        self.model, self.mode = model, mode

    def forward(self, x):
        if self.mode == 'forward':
            return self.model(x)
        # the class's method: a ``features`` submodule may shadow it
        return getattr(type(self.model), self.mode)(self.model, x)


@contextlib.contextmanager
def _submodules_first(model):
    """Within: a submodule registered under the name of a method
    (``layers.register_features``: torchvision's ``features.``) is what
    attribute lookup finds, as the trace's parameter accessor needs."""
    shadowed = [m for m in model.modules() if 'features' in m._modules
                and 'features' not in m.__dict__]
    for m in shadowed:
        m.__dict__['features'] = m._modules['features']
    try:
        yield
    finally:
        for m in shadowed:
            del m.__dict__['features']


def _export(model, input_shape, batch, device, mode, dtype):
    if batch is not None and not batch.isdigit() and not batch.isidentifier():
        raise ValueError(f'batch must be None, a digit string or a name, '
                         f'got {batch!r}')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device=\'cpu\' to '
                           'export on the CPU')
    model = model.to(device).eval()
    symbolic = bool(batch) and not batch.isdigit()
    # a symbolic batch is traced at 2: export specializes a size of 1
    b = 2 if symbolic else int(batch or 1)
    x = torch.zeros((b,) + tuple(input_shape), dtype=dtype, device=device)
    # CUDA kernels bound the batch by a grid dimension (65535), which a
    # trace on the card guards
    dynamic = (({0: torch.export.Dim(batch, min=1, max=MAX_BATCH)},)
               if symbolic else None)
    with torch.no_grad(), _submodules_first(model):
        return torch.export.export(_Mode(model, mode), (x,),
                                   dynamic_shapes=dynamic, strict=False)


def export_model(model, path: str, input_shape: Sequence[int],
                 batch: Optional[str] = None, device='cuda',
                 mode: str = 'forward', dtype=torch.float32) -> None:
    """Trace ``model`` (eval mode, on ``device``) for inputs of
    ``(batch,) + input_shape`` in ``dtype`` and save the program with its
    weights to ``path``."""
    exported = _export(model, input_shape, batch, device, mode, dtype)
    # the traced zeros would be saved too (385 MB for 20 clips of 32 x 224
    # x 224 px in f32)
    exported.example_inputs = None
    os.makedirs(os.path.dirname(os.path.abspath(path)) or '.', exist_ok=True)
    torch.export.save(exported, path)


def load_exported(path: str):
    """Returns ``(call, params)``: ``call(params, x)`` runs the reloaded
    program on ``params`` (its parameters and buffers by name, as saved),
    which may be replaced tensor by tensor, as JAX's ``call(variables,
    x)``."""
    exported = torch.export.load(path)
    module = exported.module()
    params = dict(exported.state_dict)

    def call(params, x):
        with torch.no_grad():
            return torch.func.functional_call(module, params, (x,))

    return call, params


def exported_program_text(model, input_shape: Sequence[int],
                          mode: str = 'forward', dtype=torch.float32,
                          device='cuda', batch: Optional[str] = None) -> str:
    """The exported program's graph as Python text, autocast regions
    included (for inspection: the nodes an artifact holds)."""
    exported = _export(model, input_shape, batch, device, mode, dtype)
    return exported.graph_module.print_readable(print_output=False)
