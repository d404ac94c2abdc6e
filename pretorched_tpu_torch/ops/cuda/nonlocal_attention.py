"""Non-local attention: the CUDA forward kernel, its plain version, dispatch.

Counterpart of ``pretorched_tpu/ops/pallas/nonlocal_attention.py``.
``softmax(q @ k^T * scale) @ v`` with no 1/sqrt(d) (the reference's
embedded-gaussian and gaussian modes apply none; ``scale`` covers other
uses). q is (B, N, C); k is (B, Nk, C) and v (B, Nk, Cv): Nk differs from N
under ``sub_sample``, Cv from C in SAGAN attention. Accumulation is f32.

* ``nonlocal_attention_cuda``: the hand-written kernel
  (``csrc/nonlocal_attention_fwd.cu``, replacing the TPU's ``_attn_kernel``).
  CUDA tensors only; it raises on anything it does not take.
* ``nonlocal_attention_fwd_lse_reference`` / ``nonlocal_attention_reference``:
  the plain PyTorch version, N x N scores in f32.
* ``auto_nonlocal_attention``: what the model calls. A CPU tensor takes the
  plain version; a CUDA tensor always takes the kernel.
* ``linear_nonlocal_attention``: the dot_product mode, linear in N.

The JAX package's ``PALLAS_MIN_N`` crossover was measured on a TPU v5e and is
not carried over. The backward kernels are not ported yet, so the kernel
path is inference-only: it raises if a gradient is asked of it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CV_F32 = 512  # the f32 path keeps a (64, Cv) accumulator in shared memory


def _no_autocast(device_type):
    return torch.autocast(device_type, enabled=False)


def nonlocal_attention_fwd_lse_reference(q, k, v, scale: float = 1.0):
    """Plain version: (out (B, N, Cv) in q's dtype, lse (B, N) f32)."""
    with _no_autocast(q.device.type):
        s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        out = torch.bmm(p, v.float())
    return out.to(q.dtype), lse


def nonlocal_attention_reference(q, k, v, scale: float = 1.0):
    """Plain ``softmax(q k^T scale) v`` (same math as nonlocalnet.py:143-166)."""
    return nonlocal_attention_fwd_lse_reference(q, k, v, scale)[0]


def _check_inputs(q, k, v):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_cuda:
            raise ValueError(f'nonlocal_attention_cuda: {name} is on {t.device}'
                             ', the kernel takes CUDA tensors')
        if t.dim() != 3:
            raise ValueError(f'{name} must be (B, N, C), got {tuple(t.shape)}')
        if t.dtype != q.dtype:
            raise ValueError(f'{name} is {t.dtype}, q is {q.dtype}')
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'dtype {q.dtype} not supported (float32, bfloat16)')
    b, n, c = q.shape
    if k.shape[0] != b or v.shape[0] != b:
        raise ValueError(f'batch mismatch: {q.shape} {k.shape} {v.shape}')
    if k.shape[2] != c:
        raise ValueError(f'q and k channels differ: {q.shape} {k.shape}')
    if v.shape[1] != k.shape[1]:
        raise ValueError(f'k and v lengths differ: {k.shape} {v.shape}')
    if q.dtype == torch.float32 and v.shape[2] > MAX_CV_F32:
        raise ValueError(f'Cv={v.shape[2]} > {MAX_CV_F32} does not fit the '
                         'f32 kernel\'s shared-memory accumulator')
    if min(n, k.shape[1], c, v.shape[2]) < 1 or not 1 <= b <= 65535:
        raise ValueError(f'empty or oversized shape: {q.shape} {k.shape} '
                         f'{v.shape}')
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError('the attention backward kernels are not '
                                  'ported yet; run under torch.no_grad()')


def nonlocal_attention_cuda(q, k, v, scale: float = 1.0):
    """Launch the forward kernel: returns (out (B, N, Cv), lse (B, N) f32)."""
    _check_inputs(q, k, v)
    lib = build.load_library()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, n, c = q.shape
    nk, cv = v.shape[1], v.shape[2]
    out = torch.empty((b, n, cv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_nonlocal_attention_fwd(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(lse.data_ptr()), b, n, nk, c, cv, float(scale),
            _DTYPE_CODES[q.dtype], ctypes.c_void_p(stream))
    build.check(lib, err, 'nonlocal_attention_fwd launch')
    nonlocal_attention_cuda.launches += 1
    return out, lse


nonlocal_attention_cuda.launches = 0


def nonlocal_attention_fwd_lse(q, k, v, scale: float = 1.0):
    """(out, lse): the kernel for CUDA tensors, the plain version on the CPU."""
    if q.is_cuda:
        return nonlocal_attention_cuda(q, k, v, scale)
    if q.device.type != 'cpu':
        raise ValueError(f'no non-local attention for device {q.device}')
    return nonlocal_attention_fwd_lse_reference(q, k, v, scale)


def auto_nonlocal_attention(q, k, v, scale: float = 1.0):
    """``softmax(q k^T scale) v`` for the model: see the module docstring."""
    return nonlocal_attention_fwd_lse(q, k, v, scale)[0]


def linear_nonlocal_attention(q, k, v):
    """(q @ k^T @ v) / N_keys via associativity: the reference's dot_product
    mode (nonlocalnet.py:192-210) is linear, so the N x N matrix never
    exists. The divisor is the KEY count (nonlocalnet.py:208)."""
    n = k.shape[1]
    with _no_autocast(q.device.type):
        kv = torch.bmm(k.float().transpose(1, 2), v.float())
        out = torch.bmm(q.float(), kv) / n
    return out.to(q.dtype)
