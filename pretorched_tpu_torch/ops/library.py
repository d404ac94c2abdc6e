"""The kernels of the export path as registered PyTorch operators.

``torch.export`` traces a model on FakeTensors, which have no storage: a
wrapper that launches through ``ctypes`` on ``t.data_ptr()`` cannot be
traced, and a trace taken on the CPU would record the plain version's
decomposed arithmetic. Each kernel below is therefore one operator of the
``pretorched`` namespace, with a CUDA implementation (the kernel, its
dispatch and its launch counts), a CPU implementation (the plain version)
and a fake one (the output shapes only). An exported program records the
operator itself: reloaded, it launches the kernel on the card and runs the
plain version on the CPU.

* ``pretorched::nonlocal_attention_fwd(q, k, v, scale) -> (out, lse)``:
  K1-fwd (``csrc/nonlocal_attention_fwd.cu``, the TPU's ``_attn_kernel``
  in ``pretorched_tpu/ops/pallas/nonlocal_attention.py``). out is (B, N,
  Cv) in q's dtype, lse (B, N) in f32.
* ``pretorched::fused_bottleneck_tail(y1, x_res, w2, a2, w3, a3, wp, ap)
  -> out``: K2 (``csrc/fused_block.cu``, the TPU's ``_kernel`` in
  ``pretorched_tpu/ops/pallas/fused_block.py``), eval only; ``wp`` and
  ``ap`` are None for an identity residual. Its CUDA implementation lays
  the weights out at each call (the eager SlowFast forward keeps its
  cached ``TailLayout`` and calls the kernel wrapper directly).

Neither operator has an autograd or composite kernel: nothing decomposes
them, and a device other than the CPU and CUDA has no implementation.
They are defined with ``torch.library.Library`` and registered per
dispatch key, not with ``torch.library.custom_op``, whose Python wrappers
(an autograd shim and a dynamo guard around the kernel) add host time to
every call.
Importing this module registers both (``pretorched_tpu_torch.ops`` imports
it); a process that reloads an exported program imports it and nothing
else of the port.
"""

from __future__ import annotations

import torch

from . import fused_block as fb
from .cuda import fused_block as fb_cuda
from .cuda import nonlocal_attention as na

_LIB = torch.library.Library('pretorched', 'DEF')  # noqa: TOR901
_LIB.define('nonlocal_attention_fwd(Tensor q, Tensor k, Tensor v, '
            'float scale) -> (Tensor, Tensor)')
_LIB.define('fused_bottleneck_tail(Tensor y1, Tensor x_res, Tensor w2, '
            'Tensor a2, Tensor w3, Tensor a3, Tensor? wp, Tensor? ap) '
            '-> Tensor')

_LIB.impl('nonlocal_attention_fwd', na.nonlocal_attention_fwd_lse_reference,
          'CPU')
_LIB.impl('nonlocal_attention_fwd', na.nonlocal_attention_cuda, 'CUDA')
_LIB.impl('fused_bottleneck_tail', fb.fused_bottleneck_tail_reference, 'CPU')
_LIB.impl('fused_bottleneck_tail', fb_cuda.fused_bottleneck_tail_cuda,
          'CUDA')


@torch.library.register_fake('pretorched::nonlocal_attention_fwd', lib=_LIB)
def _attention_fake(q, k, v, scale):
    # out is sized by Cv, not C; lse has one row per query of every batch
    b, n = q.shape[:2]
    return (q.new_empty((b, n, v.shape[2])),
            q.new_empty((b, n), dtype=torch.float32))


@torch.library.register_fake('pretorched::fused_bottleneck_tail', lib=_LIB)
def _tail_fake(y1, x_res, w2, a2, w3, a3, wp, ap):
    n, _, t, h, w = y1.shape
    return y1.new_empty((n, w3.shape[0], t, h, w))
