"""Non-local attention: the CUDA kernels, their plain versions, autograd.

Counterpart of ``pretorched_tpu/ops/pallas/nonlocal_attention.py``.
``softmax(q @ k^T * scale) @ v`` with no 1/sqrt(d) (the reference's
embedded-gaussian and gaussian modes apply none; ``scale`` covers other
uses). q is (B, N, C); k is (B, Nk, C) and v (B, Nk, Cv): Nk differs from N
under ``sub_sample``, Cv from C in SAGAN attention. Accumulation is f32.

* ``nonlocal_attention_cuda``: the hand-written forward kernels
  (``csrc/nonlocal_attention_fwd.cu``, replacing the TPU's ``_attn_kernel``).
* ``nonlocal_attention_bwd_cuda``: the backward, hand-written kernels
  (``csrc/nonlocal_attention_bwd.cu``, replacing ``_attn_dq_kernel`` and
  ``_attn_dkv_kernel``) behind ``nonlocal_attention_bwd_dq_cuda`` and
  ``nonlocal_attention_bwd_dkv_cuda``.
* ``attention_kernel``: the dispatch of K1-fwd, K1-dq and K1-dkv on dtype,
  shape and op: ``'wgmma'`` (bf16, C and Cv up to ``WGMMA_MAX_WIDTH``,
  multiples of 8 for K1-fwd, whose programs pad them to 64 through TMA's
  zero fill, and of 64 for K1-dq and K1-dkv: Hopper's warp-specialised
  wgmma + TMA kernels; each op takes a second, wide program past 256,
  layer 3's 512),
  ``'mma_sync'`` (every other bf16 shape), ``'tf32_wgmma'`` (f32 K1-fwd,
  K1-dq and K1-dkv with C and Cv up to ``TF32X3_MAX_WIDTH``: TF32 wgmma +
  TMA with three TF32 products per f32 product, on operands a pre-pass
  split into their TF32 halves in scratch; the f32 forward and backward of
  every model's non-local block, SAGAN's and MNIST's too), ``'tf32x3'``
  (the programs it replaced, mma.sync with the same arithmetic, by name
  only) or ``'scalar'`` (f32 past 512: gaussian mode's C = 1024). The
  kernel wrappers take CUDA tensors only and raise on anything they do not
  take; each counts its launches in ``.launches`` and per program in
  ``.by_kernel`` (``PROGRAMS``: the wide wgmma program as ``'wgmma_wide'``).
  Each C call is the span ``k1.fwd``, ``k1.dq`` or ``k1.dkv``
  (``utils.profiling``), the tf32_wgmma programs' pre-pass inside it.
* ``nonlocal_attention_fwd_lse_reference`` / ``nonlocal_attention_reference``
  / ``nonlocal_attention_bwd_reference``: the plain PyTorch versions, N x N
  matrices in f32.
* ``NonLocalAttention``: the ``torch.autograd.Function`` (the JAX package's
  custom VJP): kernels for CUDA tensors, plain versions for CPU tensors.
* ``nonlocal_attention_fwd_lse``: the forward through the registered
  operator ``pretorched::nonlocal_attention_fwd`` (``ops/library.py``),
  which ``torch.export`` records as one node.
* ``auto_nonlocal_attention``: what the model calls. Through
  ``NonLocalAttention`` when a gradient is needed, else the forward alone.
* ``linear_nonlocal_attention``: the dot_product mode, linear in N.

The JAX package's ``PALLAS_MIN_N`` crossover was measured on a TPU v5e and is
not carried over.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ...utils.profiling import span
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widest f32 Cv of K1-fwd: the tensor-core programs keep a block's O
# in registers (tf32_wgmma past 256 columns in grid.z parts), the scalar
# one in shared memory; all stop at 512
MAX_CV_F32 = 512
KERNELS = ('wgmma', 'mma_sync', 'tf32_wgmma', 'tf32x3', 'scalar')
# what ``.by_kernel`` counts: the kernels, wgmma's wide program apart
PROGRAMS = ('wgmma', 'wgmma_wide', 'mma_sync', 'tf32_wgmma', 'tf32x3',
            'scalar')
OPS = ('fwd', 'dq', 'dkv')
# The widest C and Cv the wgmma kernels take (64-channel TMA boxes). A
# warpgroup holds a (64, 256) f32 accumulator in 128 registers a thread:
# up to 256 one block's consumers split the rows, past it the columns, in
# each op's wide program.
WGMMA_MAX_WIDTH = 512
WGMMA_NARROW_WIDTH = 256
# The step of C and Cv each op's wgmma programs take: K1-fwd reads 64-channel
# TMA boxes past the last column as zeros, so it needs only TMA's 16-byte
# rows (8 bf16); K1-dq's and K1-dkv's programs take whole boxes.
WGMMA_WIDTH_STEP = {'fwd': 8, 'dq': 64, 'dkv': 64}
# The widest C and Cv the f32 tensor-core programs of K1-fwd, K1-dq and
# K1-dkv take (a block keeps the whole width of its output in registers);
# gaussian mode's C = 1024 stays on the scalar programs.
TF32X3_MAX_WIDTH = 512


def attention_kernel(dtype, c: int, cv: int, op: str) -> str:
    """The kernel ``op`` (K1-fwd, K1-dq or K1-dkv) takes for this dtype
    and C, Cv."""
    if op not in OPS:
        raise ValueError(f'op {op!r} is none of {OPS}')
    if dtype not in _DTYPE_CODES:
        raise ValueError(f'dtype {dtype} not supported (float32, bfloat16)')
    if dtype == torch.float32:
        if max(c, cv) > TF32X3_MAX_WIDTH:
            return 'scalar'
        return 'tf32_wgmma'
    step = WGMMA_WIDTH_STEP[op]
    fits = all(w % step == 0 and w <= WGMMA_MAX_WIDTH for w in (c, cv))
    return 'wgmma' if fits else 'mma_sync'


# (kernel, the dispatch's choice) pairs a private launch may take: the
# generic program of each dtype takes its every shape, and the f32
# mma.sync programs every shape of their TF32-wgmma successors, so a
# launch of the program that replaced one can be held against it
_OLDER = {('mma_sync', 'wgmma'), ('tf32x3', 'tf32_wgmma'),
          ('scalar', 'tf32_wgmma')}


def _check_kernel(dtype, c: int, cv: int, kernel: str, op: str):
    """``kernel`` must be the dispatch's choice for ``op``, or mma_sync
    where that is wgmma, tf32x3 or scalar where it is tf32_wgmma: the older
    kernels take every shape of their successors, so a launch can be held
    against the kernel it replaced."""
    chosen = attention_kernel(dtype, c, cv, op)
    if kernel != chosen and (kernel, chosen) not in _OLDER:
        raise ValueError(f'{op} kernel {kernel!r} does not take {dtype} with '
                         f'C={c}, Cv={cv} (the dispatch picks {chosen!r})')


def _program(kernel, c, cv):
    """The program of ``kernel`` that runs C, Cv: wgmma's wide one past
    256 (its C entry's suffix and its key in ``.by_kernel``)."""
    if kernel == 'wgmma' and max(c, cv) > WGMMA_NARROW_WIDTH:
        return 'wgmma_wide'
    return kernel


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


def nonlocal_attention_bwd_reference(q, k, v, o, lse, do, scale: float = 1.0):
    """Plain version of the backward (``_nonlocal_attention_bwd_blockwise``):
    (dq, dk, dv) in the inputs' dtypes, from the forward's out and lse."""
    with _no_autocast(q.device.type):
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        delta = (dof * o.float()).sum(-1)
        p = torch.exp(torch.bmm(qf, kf.transpose(1, 2)) * scale - lse[..., None])
        dv = torch.bmm(p.transpose(1, 2), dof)
        ds = torch.bmm(dof, vf.transpose(1, 2))          # dp, then ds in place
        ds.sub_(delta[..., None]).mul_(p).mul_(scale)
        del p
        dq = torch.bmm(ds, kf)
        dk = torch.bmm(ds.transpose(1, 2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    if min(n, k.shape[1], c, v.shape[2]) < 1 or not 1 <= b <= 65535:
        raise ValueError(f'empty or oversized shape: {q.shape} {k.shape} '
                         f'{v.shape}')


def _check_rows(q, v, do, lse, delta):
    b, n = q.shape[:2]
    for name, t, shape, dtype in (('do', do, (b, n, v.shape[2]), q.dtype),
                                  ('lse', lse, (b, n), torch.float32),
                                  ('delta', delta, (b, n), torch.float32)):
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {shape} {dtype} on {q.device}, '
                             f'got {tuple(t.shape)} {t.dtype} on {t.device}')


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_tma(*tensors):
    """TMA reads and writes 16-byte aligned rows from a 16-byte aligned
    base; the rows (C, Cv multiples of 8 in bf16) always are."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f'the wgmma kernels need 16-byte aligned tensors;'
                             f' got one of {tuple(t.shape)} at '
                             f'{t.data_ptr():#x}')


def tf32_wgmma_scratch_bytes(dkv: bool, b: int, n: int, nk: int, c: int,
                             cv: int) -> int:
    """Bytes of a tf32_wgmma launch's scratch, as the C entry
    ``pt_nonlocal_attention_bwd_tf32_wgmma_scratch`` lays it out: each
    operand of s and dp split into its TF32 halves, (2B, rows, channels
    padded to 64), and the column operands of the accumulating products
    transposed, (2B, channels padded to 64, streamed axis padded to 4);
    each region 256-byte aligned."""
    rows, cols = (nk, n) if dkv else (n, nk)
    cp, cvp = -(-c // 64) * 64, -(-cv // 64) * 64
    colp = -(-cols // 4) * 4

    def region(r, w):
        return -(-2 * b * r * w * 4 // 256) * 256

    return (region(rows, cp) + region(cols, cp) + region(rows, cvp)
            + region(cols, cvp) + region(cp, colp)
            + (region(cvp, colp) if dkv else 0))


def tf32_wgmma_fwd_scratch_bytes(b: int, n: int, nk: int, c: int,
                                 cv: int) -> int:
    """Bytes of a tf32_wgmma K1-fwd launch's scratch, as the C entry
    ``pt_nonlocal_attention_fwd_tf32_wgmma_scratch`` lays it out: q and k
    split into their TF32 halves, (2B, rows, C padded to 32), and v's
    halves transposed, (2B, Cv padded to 32, Nk padded to 4); each region
    256-byte aligned. Freed after the call."""
    cp, cvp = -(-c // 32) * 32, -(-cv // 32) * 32

    def region(r, w):
        return -(-2 * b * r * w * 4 // 256) * 256

    return region(n, cp) + region(nk, cp) + region(cvp, -(-nk // 4) * 4)


def _tf32_wgmma_scratch(q, v, nk, op):
    """The scratch of a tf32_wgmma launch of ``op``, in f32 words."""
    b, n, c = q.shape
    nbytes = (tf32_wgmma_fwd_scratch_bytes(b, n, nk, c, v.shape[2])
              if op == 'fwd' else tf32_wgmma_scratch_bytes(
                  op == 'dkv', b, n, nk, c, v.shape[2]))
    return torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)


def _count(fn, program):
    fn.launches += 1
    fn.by_kernel[program] += 1


def _reset(fn):
    fn.launches = 0
    fn.by_kernel = dict.fromkeys(PROGRAMS, 0)


def nonlocal_attention_cuda(q, k, v, scale: float = 1.0):
    """Launch the forward kernel that ``attention_kernel`` picks: returns
    (out (B, N, Cv), lse (B, N) f32)."""
    _check_inputs(q, k, v)
    return _launch_fwd(q, k, v, scale, attention_kernel(
        q.dtype, q.shape[2], v.shape[2], 'fwd'))


def _launch_fwd(q, k, v, scale, kernel):
    """Launch K1-fwd's ``kernel`` (checked by ``_check_kernel``) on checked
    inputs and count it on ``nonlocal_attention_cuda``."""
    if q.dtype == torch.float32 and v.shape[2] > MAX_CV_F32:
        raise ValueError(f'Cv={v.shape[2]} > {MAX_CV_F32} does not fit the '
                         'f32 kernels\' accumulator')
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, n, c = q.shape
    cv = v.shape[2]
    _check_kernel(q.dtype, c, cv, kernel, 'fwd')
    out = torch.empty((b, n, cv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    program = _program(kernel, c, cv)
    if kernel == 'wgmma':
        _check_tma(q, k, v, out)
    if kernel == 'tf32_wgmma':
        _launch('pt_nonlocal_attention_fwd_tf32_wgmma', q, v,
                (q, k, v, out, lse,
                 _tf32_wgmma_scratch(q, v, k.shape[1], 'fwd')), scale)
    elif kernel in ('wgmma', 'tf32x3'):
        _launch(f'pt_nonlocal_attention_fwd_{program}', q, v,
                (q, k, v, out, lse), scale)
    else:
        _launch('pt_nonlocal_attention_fwd', q, v, (q, k, v, out, lse), scale,
                _DTYPE_CODES[q.dtype])
    _count(nonlocal_attention_cuda, program)
    return out, lse


_reset(nonlocal_attention_cuda)


def nonlocal_attention_fwd_lse(q, k, v, scale: float = 1.0):
    """(out, lse) through the operator ``pretorched::nonlocal_attention_fwd``
    (``ops/library.py``): the kernel for CUDA tensors, the plain version on
    the CPU, and the operator itself in an exported program."""
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no non-local attention for device {q.device}')
    return torch.ops.pretorched.nonlocal_attention_fwd(q, k, v, float(scale))


def _launch(entry, q, v, tensors, scale, *dtype):
    """Call the C entry ``entry`` (``pt_nonlocal_attention_<op>...``) on
    contiguous, checked ``tensors``, the shape of q and v, ``scale`` and
    ``dtype`` (its code, for the entries that take one), on the current
    stream; raise on a launch error. The call alone is the span
    ``k1.fwd``, ``k1.dq`` or ``k1.dkv``."""
    lib = build.load_library()
    b, n, c = q.shape
    nk, cv = v.shape[1], v.shape[2]
    # pt_nonlocal_attention_fwd..., _bwd_dq... or _bwd_dkv...
    op = entry.split('_')[3:5]
    name = 'k1.' + (op[0] if op[0] == 'fwd' else op[1])
    args = (*map(_ptr, tensors), b, n, nk, c, cv, float(scale), *dtype)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(q.device).cuda_stream)
        with span(name):
            err = getattr(lib, entry)(*args, stream)
    build.check(lib, err, f'{entry} launch')


def nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float = 1.0):
    """Launch the K1-dq kernel that ``attention_kernel`` picks: dq (B, N,
    C) in q's dtype."""
    _check_inputs(q, k, v)
    _check_rows(q, v, do, lse, delta)
    return _launch_dq(q, k, v, do, lse, delta, scale, attention_kernel(
        q.dtype, q.shape[2], v.shape[2], 'dq'))


def _launch_dq(q, k, v, do, lse, delta, scale, kernel):
    """Launch K1-dq's ``kernel`` (checked by ``_check_kernel``) on checked
    inputs and count it on ``nonlocal_attention_bwd_dq_cuda``."""
    q, k, v, do, lse, delta = (t.contiguous() for t in (q, k, v, do, lse, delta))
    c, cv = q.shape[2], v.shape[2]
    _check_kernel(q.dtype, c, cv, kernel, 'dq')
    dq = torch.empty_like(q)
    program = _program(kernel, c, cv)
    if kernel == 'wgmma':
        _check_tma(q, k, v, do, dq)
    if kernel == 'tf32_wgmma':
        _launch('pt_nonlocal_attention_bwd_dq_tf32_wgmma', q, v,
                (q, k, v, do, lse, delta, dq,
                 _tf32_wgmma_scratch(q, v, k.shape[1], 'dq')), scale)
    elif kernel in ('wgmma', 'tf32x3'):
        _launch(f'pt_nonlocal_attention_bwd_dq_{program}', q, v,
                (q, k, v, do, lse, delta, dq), scale)
    else:
        _launch('pt_nonlocal_attention_bwd_dq', q, v,
                (q, k, v, do, lse, delta, dq), scale, _DTYPE_CODES[q.dtype])
    _count(nonlocal_attention_bwd_dq_cuda, program)
    return dq


def nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                    scale: float = 1.0):
    """Launch the K1-dkv kernel that ``attention_kernel`` picks: (dk (B, Nk,
    C), dv (B, Nk, Cv)) in k's and v's dtype."""
    _check_inputs(q, k, v)
    _check_rows(q, v, do, lse, delta)
    return _launch_dkv(q, k, v, do, lse, delta, scale, attention_kernel(
        q.dtype, q.shape[2], v.shape[2], 'dkv'))


def _launch_dkv(q, k, v, do, lse, delta, scale, kernel):
    """Launch K1-dkv's ``kernel`` (checked by ``_check_kernel``) on checked
    inputs and count it on ``nonlocal_attention_bwd_dkv_cuda``."""
    q, k, v, do, lse, delta = (t.contiguous() for t in (q, k, v, do, lse, delta))
    c, cv = q.shape[2], v.shape[2]
    _check_kernel(q.dtype, c, cv, kernel, 'dkv')
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    program = _program(kernel, c, cv)
    if kernel == 'wgmma':
        _check_tma(q, k, v, do, dk, dv)
    if kernel == 'tf32_wgmma':
        _launch('pt_nonlocal_attention_bwd_dkv_tf32_wgmma', q, v,
                (q, k, v, do, lse, delta, dk, dv,
                 _tf32_wgmma_scratch(q, v, k.shape[1], 'dkv')), scale)
    elif kernel in ('wgmma', 'tf32x3'):
        _launch(f'pt_nonlocal_attention_bwd_dkv_{program}', q, v,
                (q, k, v, do, lse, delta, dk, dv), scale)
    else:
        _launch('pt_nonlocal_attention_bwd_dkv', q, v,
                (q, k, v, do, lse, delta, dk, dv), scale,
                _DTYPE_CODES[q.dtype])
    _count(nonlocal_attention_bwd_dkv_cuda, program)
    return dk, dv


_reset(nonlocal_attention_bwd_dq_cuda)
_reset(nonlocal_attention_bwd_dkv_cuda)


def nonlocal_attention_bwd_cuda(q, k, v, o, lse, do, scale: float = 1.0):
    """The backward on the card: ``delta = rowsum(do * o)`` in plain torch
    (the JAX package also computes it outside Pallas), then K1-dq and
    K1-dkv. Returns (dq, dk, dv) in the inputs' dtypes."""
    _check_inputs(q, k, v)
    if o.shape != do.shape or o.device != q.device:
        raise ValueError(f'o {tuple(o.shape)} on {o.device} does not match '
                         f'do {tuple(do.shape)} on {q.device}')
    with _no_autocast('cuda'):
        delta = (do.float() * o.float()).sum(-1)
    dq = nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale)
    dk, dv = nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class NonLocalAttention(torch.autograd.Function):
    """``softmax(q k^T scale) v`` with the blockwise backward (the JAX
    package's ``_nonlocal_attention_ad``). The forward saves q, k, v, out
    and lse; both directions take the kernels for CUDA tensors and the plain
    versions for CPU tensors, with autocast off inside."""

    @staticmethod
    @torch.amp.custom_fwd(device_type='cuda')
    def forward(ctx, q, k, v, scale: float = 1.0):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = nonlocal_attention_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    @torch.amp.custom_bwd(device_type='cuda')
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (nonlocal_attention_bwd_cuda if q.is_cuda
               else nonlocal_attention_bwd_reference)
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def auto_nonlocal_attention(q, k, v, scale: float = 1.0):
    """``softmax(q k^T scale) v`` for the model: through ``NonLocalAttention``
    when a gradient is needed, else the forward alone (one launch on the
    card, nothing saved)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return NonLocalAttention.apply(q, k, v, scale)
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
