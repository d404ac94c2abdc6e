"""The port's non-local attention against the JAX package's.

On the CPU the dispatcher takes the plain version, which is compared with
the Pallas forward (``interpret=True``) for out and lse at 1e-4. The kernel
itself runs only on a CUDA card: ``tests/test_torch_kernels_gpu.py``
compares it with the plain version there, at these same cases.
"""

import inspect

import numpy as np
import pytest
import torch

from pretorched_tpu.ops.pallas.nonlocal_attention import (
    _nonlocal_attention_fwd_lse)
from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

# (B, N, Nk, C, Cv, scale): square; Nk != N (sub_sample); Cv != C (SAGAN);
# scale != 1; B > 1 with N not a multiple of 128 — including the two past
# faults: lse shaped per row for B > 1, and v/out sized by Cv, not C; and
# layer 3's width (C = Cv = 512) at a small N, its scale ~ 1/sqrt(C) so
# the softmax is not one-hot; SAGAN's C = 48, Cv = 4 C (biggan128, keys
# pooled 2x2). All at 1e-4 (f32 on both sides).
CASES = [
    (1, 256, 256, 32, 32, 1.0),
    (2, 300, 300, 32, 32, 1.0),
    (2, 300, 72, 32, 32, 0.5),
    (2, 300, 72, 16, 64, 1.0),
    (3, 200, 200, 16, 16, 0.25),
    (2, 130, 520, 8, 24, 2.0),
    (2, 96, 80, 512, 512, 0.05),
    (2, 256, 64, 48, 192, 1.0),
]


def _inputs(b, n, nk, c, cv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, c).astype(np.float32),
            rng.randn(b, nk, c).astype(np.float32),
            rng.randn(b, nk, cv).astype(np.float32))


@pytest.mark.parametrize('b,n,nk,c,cv,scale', CASES)
def test_plain_matches_pallas(b, n, nk, c, cv, scale):
    q, k, v = _inputs(b, n, nk, c, cv)
    want_out, want_lse = (np.asarray(a) for a in _nonlocal_attention_fwd_lse(
        q, k, v, scale=scale, interpret=True))      # waits for XLA first
    before = na.nonlocal_attention_cuda.launches
    out, lse = na.nonlocal_attention_fwd_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert na.nonlocal_attention_cuda.launches == before   # CPU: plain path
    assert out.shape == (b, n, cv) and lse.shape == (b, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=1e-4, atol=1e-4)


def test_linear_attention_matches_jax():
    from pretorched_tpu.ops.pallas.nonlocal_attention import (
        linear_nonlocal_attention)
    q, k, v = _inputs(2, 300, 72, 16, 24, seed=1)
    want = np.asarray(linear_nonlocal_attention(q, k, v))
    got = na.linear_nonlocal_attention(*(torch.from_numpy(a)
                                         for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused before
    any build is attempted."""
    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match='CUDA'):
        na.nonlocal_attention_cuda(q, q, q)


def test_plain_runs_f32_under_autocast():
    """Under bf16 autocast the plain version still accumulates in f32 (the
    kernel does), and returns q's dtype."""
    q, k, v = _inputs(1, 64, 64, 16, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = na.nonlocal_attention_reference(tq, tk, tv)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        got = na.nonlocal_attention_reference(tq, tk, tv)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# (dtype, C, Cv, kernel): the kernel of K1-fwd, K1-dq and K1-dkv, or
# 'fwd,dq,dkv' where they differ. bf16 with C and Cv multiples of 64 up to
# 512 (the layer-2 and sub_sample shapes, Cv != C, the smallest; layer 3,
# Cv != C, one side narrow, on each op's wide program) takes wgmma
# everywhere; multiples of 8 that are not of 64 (MNISTNonLocalNet's 16 and
# 32, SAGAN's 48 / 192 and 96 / 384, the golden lock's 16 / 64) take wgmma
# in K1-fwd, whose programs pad them, and mma.sync in the backward;
# gaussian mode (1024), past 512 and channels that are no multiple of 8
# stay on mma.sync; f32 is scalar
DISPATCH = [
    (torch.bfloat16, 256, 256, 'wgmma'),
    (torch.bfloat16, 64, 256, 'wgmma'),
    (torch.bfloat16, 256, 64, 'wgmma'),
    (torch.bfloat16, 64, 64, 'wgmma'),
    (torch.bfloat16, 128, 192, 'wgmma'),
    (torch.bfloat16, 512, 512, 'wgmma'),
    (torch.bfloat16, 1024, 512, 'mma_sync'),
    (torch.bfloat16, 256, 320, 'wgmma'),
    (torch.bfloat16, 32, 32, 'wgmma,mma_sync,mma_sync'),
    (torch.bfloat16, 96, 64, 'wgmma,mma_sync,mma_sync'),
    (torch.float32, 256, 256, 'scalar'),
    (torch.float32, 32, 24, 'scalar'),
    (torch.bfloat16, 64, 512, 'wgmma'),
    (torch.bfloat16, 512, 64, 'wgmma'),
    (torch.bfloat16, 384, 320, 'wgmma'),
    (torch.bfloat16, 576, 512, 'mma_sync'),
    (torch.bfloat16, 512, 480, 'wgmma,mma_sync,mma_sync'),
    (torch.float32, 512, 512, 'scalar'),
    (torch.bfloat16, 96, 384, 'wgmma,mma_sync,mma_sync'),
    (torch.bfloat16, 48, 192, 'wgmma,mma_sync,mma_sync'),
    (torch.bfloat16, 16, 64, 'wgmma,mma_sync,mma_sync'),
    (torch.bfloat16, 8, 8, 'wgmma,mma_sync,mma_sync'),
    (torch.bfloat16, 20, 64, 'mma_sync'),
]


def kernels_by_op(kernel):
    """{'fwd': .., 'dq': .., 'dkv': ..} from a DISPATCH entry's kernel."""
    names = kernel.split(',')
    return dict(zip(na.OPS, names if len(names) == 3 else names * 3))


# each case's id: the dtype's index, C, Cv and K1-dq's kernel
DISPATCH_IDS = [f'dtype{i}-{c}-{cv}-{kernels_by_op(kernel)["dq"]}'
                for i, (_, c, cv, kernel) in enumerate(DISPATCH)]


@pytest.mark.parametrize('dtype,c,cv,kernel', DISPATCH, ids=DISPATCH_IDS)
def test_dispatch_picks_kernel_by_dtype_and_shape(dtype, c, cv, kernel):
    for op, want in kernels_by_op(kernel).items():
        assert na.attention_kernel(dtype, c, cv, op) == want, op
        na._check_kernel(dtype, c, cv, want, op)


def test_dispatch_takes_mma_sync_by_name_and_refuses_the_rest():
    """The private launch routes may send a wgmma shape to the mma.sync
    kernels (the A/B against the kernel wgmma replaced, at layer 3 too);
    nothing else is forced: no op has a wgmma program past 512. The public
    wrappers take no kernel choice."""
    for op in na.OPS:
        na._check_kernel(torch.bfloat16, 256, 256, 'mma_sync', op)
        na._check_kernel(torch.bfloat16, 512, 512, 'mma_sync', op)
        na._check_kernel(torch.bfloat16, 512, 512, 'wgmma', op)
    with pytest.raises(ValueError, match='dq kernel .* does not take'):
        na._check_kernel(torch.bfloat16, 1024, 512, 'wgmma', 'dq')
    with pytest.raises(ValueError, match='does not take'):
        na._check_kernel(torch.bfloat16, 1024, 512, 'wgmma', 'fwd')
    with pytest.raises(ValueError, match='does not take'):
        na._check_kernel(torch.float32, 256, 256, 'wgmma', 'fwd')
    with pytest.raises(ValueError, match='does not take'):
        na._check_kernel(torch.float32, 256, 256, 'mma_sync', 'dkv')
    with pytest.raises(ValueError, match='not supported'):
        na.attention_kernel(torch.float16, 256, 256, 'fwd')
    with pytest.raises(ValueError, match='none of'):
        na.attention_kernel(torch.bfloat16, 256, 256, 'bwd')
    for fn in (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
               na.nonlocal_attention_bwd_dkv_cuda):
        assert 'kernel' not in inspect.signature(fn).parameters


@pytest.mark.parametrize('dtype,c,cv,kernel', DISPATCH, ids=DISPATCH_IDS)
def test_fwd_and_dkv_dispatch_route_each_shape(monkeypatch, dtype, c, cv,
                                               kernel):
    """K1-fwd and K1-dkv call the C entry of the kernel the dispatch picks:
    wgmma's narrow entry up to 256, its wide entry past it (no dtype code),
    the mma.sync / scalar entry with its dtype code otherwise; each launch
    is counted under its program (the wide one as ``wgmma_wide``). The C
    entries are replaced by a recorder, so no card is needed."""
    entries = []
    monkeypatch.setattr(na, '_launch',
                        lambda entry, *args: entries.append((entry, args[-1])))
    q = torch.zeros(1, 8, c, dtype=dtype)
    v = torch.zeros(1, 8, cv, dtype=dtype)
    stats = torch.zeros(1, 8)
    wide = '_wide' if max(c, cv) > 256 else ''
    for op, fn, name in (
            ('fwd', na.nonlocal_attention_cuda, 'pt_nonlocal_attention_fwd'),
            ('dkv', na.nonlocal_attention_bwd_dkv_cuda,
             'pt_nonlocal_attention_bwd_dkv')):
        chosen = kernels_by_op(kernel)[op]
        program = chosen + wide if chosen == 'wgmma' else chosen
        before = dict(fn.by_kernel)
        entries.clear()
        if op == 'fwd':
            out, lse = na._launch_fwd(q, q, v, 1.0, chosen)
            assert out.shape == (1, 8, cv) and lse.shape == (1, 8)
        else:
            dk, dv = na._launch_dkv(q, q, v, v, stats, stats, 1.0, chosen)
            assert dk.shape == q.shape and dv.shape == v.shape
        if chosen == 'wgmma':
            assert entries == [(f'{name}_{program}', 1.0)], op
        else:
            assert entries == [(name, na._DTYPE_CODES[dtype])], op
        assert {k: fn.by_kernel[k] - before[k] for k in na.PROGRAMS} == {
            k: int(k == program) for k in na.PROGRAMS}


def test_launch_counters_are_kept_per_kernel():
    for fn in (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
               na.nonlocal_attention_bwd_dkv_cuda):
        assert set(fn.by_kernel) == set(na.PROGRAMS) >= set(na.KERNELS)
