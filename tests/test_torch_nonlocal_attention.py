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

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

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
# stay on mma.sync; f32 takes tf32_wgmma in K1-fwd, K1-dq and K1-dkv up to
# 512
F32 = 'tf32_wgmma'
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
    (torch.float32, 256, 256, F32),
    (torch.float32, 32, 24, F32),
    (torch.bfloat16, 64, 512, 'wgmma'),
    (torch.bfloat16, 512, 64, 'wgmma'),
    (torch.bfloat16, 384, 320, 'wgmma'),
    (torch.bfloat16, 576, 512, 'mma_sync'),
    (torch.bfloat16, 512, 480, 'wgmma,mma_sync,mma_sync'),
    (torch.float32, 512, 512, F32),
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


# each case's id: its index, C, Cv and K1-dq's kernel in bf16; an f32 case
# keeps the name of the scalar K1-fwd it was first written for, whichever
# programs the dispatch now gives it
DISPATCH_IDS = [f'dtype{i}-{c}-{cv}-'
                + ('scalar' if dtype == torch.float32
                   else kernels_by_op(kernel)['dq'])
                for i, (dtype, c, cv, kernel) in enumerate(DISPATCH)]


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
    wgmma's narrow entry up to 256, its wide entry past it, tf32x3's and
    tf32_wgmma's (no dtype code in these), the mma.sync / scalar entry with
    its dtype code otherwise; each launch
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
        if chosen in ('wgmma', 'tf32x3', 'tf32_wgmma'):
            assert entries == [(f'{name}_{program}', 1.0)], op
        else:
            assert entries == [(name, na._DTYPE_CODES[dtype])], op
        assert {k: fn.by_kernel[k] - before[k] for k in na.PROGRAMS} == {
            k: int(k == program) for k in na.PROGRAMS}


def test_launch_counters_are_kept_per_kernel():
    for fn in (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
               na.nonlocal_attention_bwd_dkv_cuda):
        assert set(fn.by_kernel) == set(na.PROGRAMS) >= set(na.KERNELS)


# f32 widths of K1-dq and K1-dkv: the models' (MNIST's 16 and 32, SAGAN's
# 48 / 192 and 96 / 384, layers 2 and 3) and the card tests' odd ones take
# tf32_wgmma up to 512 (K1-fwd too); gaussian mode's C = 1024 and
# anything wider stay scalar. Each case keeps the id of the program it was
# first written for.
F32_BACKWARD = [
    (16, 16, 'tf32_wgmma'), (32, 32, 'tf32_wgmma'), (48, 192, 'tf32_wgmma'),
    (96, 384, 'tf32_wgmma'), (256, 256, 'tf32_wgmma'),
    (512, 512, 'tf32_wgmma'), (8, 24, 'tf32_wgmma'), (20, 150, 'tf32_wgmma'),
    (392, 260, 'tf32_wgmma'), (1, 512, 'tf32_wgmma'),
    (1024, 512, 'scalar'), (512, 513, 'scalar'),
]
F32_BACKWARD_IDS = [f'{c}-{cv}-' + ('scalar' if k == 'scalar' else 'tf32x3')
                    for c, cv, k in F32_BACKWARD]


@pytest.mark.parametrize('c,cv,kernel', F32_BACKWARD, ids=F32_BACKWARD_IDS)
def test_f32_backward_dispatch_by_width(c, cv, kernel):
    """f32 K1-dq and K1-dkv take tf32_wgmma wherever C and Cv are at most
    512, else scalar; so does f32 K1-fwd."""
    for op in na.OPS:
        assert na.attention_kernel(torch.float32, c, cv, op) == kernel, op


def test_f32_backward_takes_scalar_by_name_where_tf32x3_is_picked():
    """The private launch routes may send a shape of the f32 tensor-core
    programs to the scalar program or to tf32x3 (the A/Bs against the
    programs tf32_wgmma replaced); tf32x3 takes no shape past 512 and no
    bf16, in K1-dq, K1-dkv and K1-fwd alike."""
    for op in na.OPS:
        na._check_kernel(torch.float32, 256, 256, 'scalar', op)
        na._check_kernel(torch.float32, 512, 512, 'tf32x3', op)
        with pytest.raises(ValueError, match=f'{op} kernel .* does not take'):
            na._check_kernel(torch.float32, 1024, 512, 'tf32x3', op)
        with pytest.raises(ValueError, match='does not take'):
            na._check_kernel(torch.bfloat16, 256, 256, 'tf32x3', op)
        with pytest.raises(ValueError, match='does not take'):
            na._check_kernel(torch.float32, 256, 256, 'mma_sync', op)


@pytest.mark.parametrize('c,cv', [(256, 512), (512, 512), (20, 150)])
def test_f32_backward_takes_the_older_programs_by_name(c, cv):
    """Where the dispatch picks tf32_wgmma for K1-fwd, K1-dq and K1-dkv,
    the mma.sync tf32x3 program and the scalar one are still taken by name
    (the A/B against the programs it replaced); tf32_wgmma is taken for
    neither bf16 nor past 512, and no bf16 program for f32."""
    for op in na.OPS:
        assert na.attention_kernel(torch.float32, c, cv, op) == 'tf32_wgmma'
        for kernel in ('tf32_wgmma', 'tf32x3', 'scalar'):
            na._check_kernel(torch.float32, c, cv, kernel, op)
        for kernel in ('wgmma', 'mma_sync'):
            with pytest.raises(ValueError, match=f'{op} kernel .* does not'):
                na._check_kernel(torch.float32, c, cv, kernel, op)
        with pytest.raises(ValueError, match='does not take'):
            na._check_kernel(torch.float32, 1024, cv, 'tf32_wgmma', op)
        with pytest.raises(ValueError, match='does not take'):
            na._check_kernel(torch.bfloat16, c, cv, 'tf32_wgmma', op)


@pytest.mark.parametrize('dkv,b,n,nk,c,cv', [
    (False, 8, 6272, 6272, 256, 256), (True, 8, 6272, 6272, 256, 256),
    (True, 8, 784, 784, 512, 512), (False, 3, 130, 77, 40, 72),
    (True, 3, 130, 77, 40, 72)])
def test_tf32_wgmma_scratch_holds_the_split_operands(dkv, b, n, nk, c, cv):
    """The scratch of a tf32_wgmma launch (the C entry's layout, held
    equal to it on the card) holds each operand of s and dp as its two TF32
    halves, channels padded to 64, and the column operands of the
    accumulating products transposed, the streamed axis padded to 4: at
    layer 2, 10 (K1-dq) and 12 (K1-dkv) f32 copies of a 51 MB operand."""
    got = na.tf32_wgmma_scratch_bytes(dkv, b, n, nk, c, cv)
    pad = lambda x, m: -(-x // m) * m   # noqa: E731
    rows, cols = (nk, n) if dkv else (n, nk)
    floats = 2 * b * (rows * pad(c, 64) + cols * pad(c, 64)
                      + rows * pad(cv, 64) + cols * pad(cv, 64)
                      + pad(c, 64) * pad(cols, 4)
                      + (pad(cv, 64) * pad(cols, 4) if dkv else 0))
    assert 4 * floats <= got < 4 * floats + 6 * 256
    if (n, c, cv) == (6272, 256, 256):
        assert got == (12 if dkv else 10) * 4 * b * n * c


@pytest.mark.parametrize('c,cv,kernel', [(256, 256, 'tf32x3'),
                                         (1024, 512, 'scalar')])
def test_f32_backward_routes_to_its_entries(monkeypatch, c, cv, kernel):
    """K1-dq and K1-dkv in f32 call tf32_wgmma's entries (no dtype code,
    a scratch tensor after the outputs) where the dispatch picks it,
    tf32x3's by name there and the scalar entries (dtype code 0) otherwise,
    also when scalar is asked for by name at a tf32_wgmma shape; each
    launch is counted under its program. The C entries are replaced by a
    recorder."""
    entries = []
    monkeypatch.setattr(na, '_launch',
                        lambda entry, *args: entries.append((entry, args[-1])))
    q = torch.zeros(1, 8, c)
    v = torch.zeros(1, 8, cv)
    stats = torch.zeros(1, 8)
    programs = (kernel, 'scalar') + (('tf32_wgmma',) if kernel == 'tf32x3'
                                     else ())
    for program in programs:
        for fn, launch, name in (
                (na.nonlocal_attention_bwd_dq_cuda, na._launch_dq,
                 'pt_nonlocal_attention_bwd_dq'),
                (na.nonlocal_attention_bwd_dkv_cuda, na._launch_dkv,
                 'pt_nonlocal_attention_bwd_dkv')):
            before = dict(fn.by_kernel)
            entries.clear()
            outs = launch(q, q, v, v, stats, stats, 1.0, program)
            assert [o.shape for o in (outs if isinstance(outs, tuple)
                                      else (outs,))] == (
                [q.shape] if fn is na.nonlocal_attention_bwd_dq_cuda
                else [q.shape, v.shape])
            assert entries == ([(f'{name}_{program}', 1.0)]
                               if program != 'scalar' else [(name, 0)])
            assert {k: fn.by_kernel[k] - before[k] for k in na.PROGRAMS} == {
                k: int(k == program) for k in na.PROGRAMS}


def _tf32(x):
    """cvt.rna.tf32.f32 on f32 bits: round to nearest, ties away from zero,
    to 10 mantissa bits (the low 13 bits cleared)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _mm(a, b, terms):
    """a @ b (batched) as the tf32x3 kernels form it: each f32 operand
    split into TF32 halves hi = tf32(x), lo = tf32(x - hi), and the
    products lo hi + hi lo + hi hi summed in f32 (each TF32 product is
    exact in f32); ``terms=1``: hi hi alone, one TF32 product."""
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    hh = torch.bmm(*map(torch.from_numpy, (ahi, bhi)))
    if terms == 1:
        return hh.numpy()
    small = (torch.bmm(*map(torch.from_numpy, (alo, bhi)))
             + torch.bmm(*map(torch.from_numpy, (ahi, blo))))
    return (small + hh).numpy()


def _split_backward(q, k, v, do, lse, delta, scale, terms):
    """dq, dk, dv with every product of K1-dq and K1-dkv (s, dp, ds k,
    ds^T q, p^T do) formed by ``_mm``."""
    kt = k.transpose(0, 2, 1)
    s = _mm(q, kt, terms)
    dp = _mm(do, v.transpose(0, 2, 1), terms)
    p = np.exp(s * np.float32(scale) - lse[..., None]).astype(np.float32)
    ds = (p * (dp - delta[..., None]) * np.float32(scale)).astype(np.float32)
    return (_mm(ds, k, terms), _mm(ds.transpose(0, 2, 1), q, terms),
            _mm(p.transpose(0, 2, 1), do, terms))


def test_three_tf32_products_keep_the_f32_tolerance():
    """The split arithmetic of the tf32x3 programs, emulated on the CPU:
    three TF32 products per f32 product give dq, dk, dv within 1e-4 of the
    largest gradient of the plain backward (the card's f32 tolerance, which
    one TF32 product misses). B > 1, Nk != N, Cv != C, scale != 1."""
    b, n, nk, c, cv, scale = 2, 300, 72, 64, 96, 0.5
    rng = np.random.RandomState(5)
    q = (rng.randn(b, n, c) / c ** 0.25).astype(np.float32)
    k = (rng.randn(b, nk, c) / c ** 0.25).astype(np.float32)
    v = rng.randn(b, nk, cv).astype(np.float32)
    do = rng.randn(b, n, cv).astype(np.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = na.nonlocal_attention_fwd_lse_reference(tq, tk, tv, scale)
    want = na.nonlocal_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                               scale)
    delta = (do * out.numpy()).sum(-1).astype(np.float32)
    rels = {}
    for terms in (3, 1):
        got = _split_backward(q, k, v, do, lse.numpy(), delta, scale, terms)
        rels[terms] = [float(np.abs(g - w.numpy()).max() / np.abs(w.numpy()).max())
                       for g, w in zip(got, want)]
    assert max(rels[3]) <= 1e-4, rels
    assert max(rels[1]) > 1e-4, rels


# f32 widths of K1-fwd: the models' (MNIST's 16 and 32, SAGAN's 48 / 192
# and 96 / 384, the golden lock's 16 / 64, layers 2 and 3) and odd ones
# take tf32_wgmma up to 512; gaussian mode's C = 1024 and anything wider
# stay scalar. Each case keeps the id of the program it was first written
# for.
F32_FORWARD = [
    (16, 16, 'tf32_wgmma'), (32, 32, 'tf32_wgmma'), (48, 192, 'tf32_wgmma'),
    (96, 384, 'tf32_wgmma'), (16, 64, 'tf32_wgmma'),
    (256, 256, 'tf32_wgmma'), (512, 512, 'tf32_wgmma'),
    (7, 5, 'tf32_wgmma'), (20, 151, 'tf32_wgmma'),
    (1024, 512, 'scalar'), (512, 513, 'scalar'), (513, 64, 'scalar'),
]
F32_FORWARD_IDS = [f'{c}-{cv}-' + ('scalar' if k == 'scalar' else 'tf32x3')
                   for c, cv, k in F32_FORWARD]


@pytest.mark.parametrize('c,cv,kernel', F32_FORWARD, ids=F32_FORWARD_IDS)
def test_f32_forward_dispatch_by_width(c, cv, kernel):
    """f32 K1-fwd takes tf32_wgmma wherever C and Cv are at most 512, else
    scalar; where tf32_wgmma is picked the tf32x3 and scalar programs are
    still taken by name, and no bf16 program is."""
    assert na.attention_kernel(torch.float32, c, cv, 'fwd') == kernel
    na._check_kernel(torch.float32, c, cv, kernel, 'fwd')
    na._check_kernel(torch.float32, c, cv, 'scalar', 'fwd')
    older = ('tf32x3',) if kernel == 'tf32_wgmma' else ()
    for name in older:
        na._check_kernel(torch.float32, c, cv, name, 'fwd')
    for other in ('wgmma', 'mma_sync') + (
            ('tf32x3', 'tf32_wgmma') if kernel == 'scalar' else ()):
        with pytest.raises(ValueError, match='fwd kernel .* does not take'):
            na._check_kernel(torch.float32, c, cv, other, 'fwd')


@pytest.mark.parametrize('c,cv,kernel', [(256, 256, 'tf32_wgmma'),
                                         (48, 192, 'tf32_wgmma'),
                                         (1024, 512, 'scalar')],
                         ids=['256-256-tf32x3', '48-192-tf32x3',
                              '1024-512-scalar'])
def test_f32_forward_routes_to_its_entries(monkeypatch, c, cv, kernel):
    """K1-fwd in f32 calls tf32_wgmma's entry (no dtype code, a scratch
    tensor after lse) where the dispatch picks it, tf32x3's by name there
    and the scalar entry (dtype code 0) otherwise, also when scalar is
    asked for by name at a tf32_wgmma shape; each launch is counted under
    its program, out sized by Cv and lse per row. The C entries are
    replaced by a recorder."""
    entries = []
    monkeypatch.setattr(na, '_launch',
                        lambda entry, *args: entries.append((entry, args[-1])))
    q = torch.zeros(2, 8, c)
    k = torch.zeros(2, 5, c)
    v = torch.zeros(2, 5, cv)
    fn = na.nonlocal_attention_cuda
    programs = (kernel, 'scalar') + (('tf32x3',) if kernel == 'tf32_wgmma'
                                     else ())
    for program in programs:
        before = dict(fn.by_kernel)
        entries.clear()
        out, lse = na._launch_fwd(q, k, v, 1.0, program)
        assert out.shape == (2, 8, cv) and lse.shape == (2, 8)
        assert entries == ([(f'pt_nonlocal_attention_fwd_{program}', 1.0)]
                           if program != 'scalar'
                           else [('pt_nonlocal_attention_fwd', 0)])
        assert {p: fn.by_kernel[p] - before[p] for p in na.PROGRAMS} == {
            p: int(p == program) for p in na.PROGRAMS}


@pytest.mark.parametrize('b,n,nk,c,cv', [
    (8, 6272, 6272, 256, 256), (8, 784, 784, 512, 512),
    (32, 4096, 1024, 96, 384), (32, 4096, 1024, 48, 192),
    (64, 196, 196, 16, 16), (64, 49, 49, 32, 32), (3, 130, 77, 7, 5)],
    ids=['layer2', 'layer3', 'biggan256', 'biggan128', 'mnist16', 'mnist32',
         'ragged'])
def test_tf32_wgmma_forward_gets_its_scratch(monkeypatch, b, n, nk, c, cv):
    """K1-fwd's tf32_wgmma entry gets q, k, v, out, lse and then its
    scratch, f32 words of ``tf32_wgmma_fwd_scratch_bytes``: q's and k's two
    TF32 halves, channels padded to 32, and v's transposed, Cv padded to 32
    and the keys to 4, each region 256-byte aligned; at layer 2 six f32
    copies of a 51 MB operand (308 MB). The C entry is replaced by a
    recorder, and the tensors are never written."""
    calls = []
    monkeypatch.setattr(na, '_launch', lambda entry, q, v, tensors, scale:
                        calls.append((entry, q.shape, v.shape, tensors)))
    q = torch.empty(b, n, c)
    k = torch.empty(b, nk, c)
    v = torch.empty(b, nk, cv)
    out, lse = na._launch_fwd(q, k, v, 0.5, 'tf32_wgmma')
    [(entry, qs, vs, tensors)] = calls
    assert entry == 'pt_nonlocal_attention_fwd_tf32_wgmma'
    assert (qs, vs) == (q.shape, v.shape) and len(tensors) == 6
    assert tensors[3] is out and tensors[4] is lse
    scratch = tensors[5]
    assert scratch.dtype == torch.float32 and scratch.dim() == 1
    got = na.tf32_wgmma_fwd_scratch_bytes(b, n, nk, c, cv)
    assert scratch.numel() * 4 == got
    pad = lambda x, m: -(-x // m) * m   # noqa: E731
    regions = [2 * b * n * pad(c, 32), 2 * b * nk * pad(c, 32),
               2 * b * pad(cv, 32) * pad(nk, 4)]
    assert got == sum(pad(4 * r, 256) for r in regions)
    if (n, c, cv) == (6272, 256, 256):
        assert got == 6 * 4 * b * n * c == 308281344


def _split_forward(q, k, v, scale, terms, tile=64, stage=None):
    """(out, lse) as the tf32x3 K1-fwd forms them: s by ``_mm``, then the
    online softmax over ``tile``-key tiles, each tile's p v formed by
    ``_mm`` from zero and folded in by f32 arithmetic, o = alpha o + p v.
    ``stage``: s summed in f32 over stages of that many channels, each
    formed by ``_mm`` from zero (the tf32_wgmma program's stages)."""
    kt = k.transpose(0, 2, 1)
    if stage is None:
        s = _mm(q, kt, terms)
    else:
        s = np.zeros((q.shape[0], q.shape[1], k.shape[1]), np.float32)
        for j in range(0, q.shape[2], stage):
            s = (s + _mm(np.ascontiguousarray(q[..., j:j + stage]),
                         np.ascontiguousarray(kt[:, j:j + stage]),
                         terms)).astype(np.float32)
    s = s * np.float32(scale)
    b, n, nk = s.shape
    m = np.full((b, n), -1e30, np.float32)
    l = np.zeros((b, n), np.float32)
    o = np.zeros((b, n, v.shape[2]), np.float32)
    for j in range(0, nk, tile):
        st = s[..., j:j + tile]
        m_new = np.maximum(m, st.max(-1))
        alpha = np.exp(m - m_new).astype(np.float32)
        p = np.exp(st - m_new[..., None]).astype(np.float32)
        l = (l * alpha + p.sum(-1)).astype(np.float32)
        o = (alpha[..., None] * o + _mm(p, v[:, j:j + tile], terms)).astype(
            np.float32)
        m = m_new
    return (o / l[..., None]).astype(np.float32), (m + np.log(l)).astype(
        np.float32)


def test_three_tf32_products_keep_the_f32_forward_tolerance():
    """The split arithmetic of the tf32x3 K1-fwd, emulated on the CPU, held
    to the JAX package's forward (the Pallas kernel in interpret mode):
    three TF32 products per f32 product keep out within 2e-4 and lse
    within 1e-4 (the card's f32 tolerances); one TF32 product alone does
    not here (logits of raw randn at C = 40: errors of ~3e-3). B > 1, Nk !=
    N and no multiple of 64 (a ragged last key tile), C no multiple of 64,
    Cv != C, scale != 1."""
    b, n, nk, c, cv, scale = 2, 300, 200, 40, 72, 0.5
    q, k, v = _inputs(b, n, nk, c, cv, seed=5)
    want_out, want_lse = (np.asarray(a) for a in _nonlocal_attention_fwd_lse(
        q, k, v, scale=scale, interpret=True))
    errs = {}
    for terms in (3, 1):
        out, lse = _split_forward(q, k, v, scale, terms)
        assert out.shape == (b, n, cv) and lse.shape == (b, n)
        errs[terms] = (float(np.abs(out - want_out).max()),
                       float(np.abs(lse - want_lse).max()))
    assert errs[3][0] <= 2e-4 and errs[3][1] <= 1e-4, errs
    assert errs[1][0] > 2e-4 and errs[1][1] > 1e-4, errs


def test_tf32_wgmma_forward_arithmetic_keeps_the_f32_tolerance():
    """The promoted arithmetic of the tf32_wgmma K1-fwd, emulated on the
    CPU: s summed over 32-channel stages, each from zero (three TF32
    products per f32 product) and joined by an f32 add; P split into its
    TF32 halves; each 64-key tile's P v from zero, folded in as o = alpha o
    + partial. Held to the JAX package's forward (the Pallas kernel in
    interpret mode) within out 2e-4 and lse 1e-4, which one TF32 product
    misses. B > 1, Nk != N and no multiple of 64, C = 40 (a stage of 8
    channels and 24 zeros), Cv != C, scale != 1."""
    b, n, nk, c, cv, scale = 2, 300, 200, 40, 72, 0.5
    q, k, v = _inputs(b, n, nk, c, cv, seed=7)
    want_out, want_lse = (np.asarray(a) for a in _nonlocal_attention_fwd_lse(
        q, k, v, scale=scale, interpret=True))
    errs = {}
    for terms in (3, 1):
        out, lse = _split_forward(q, k, v, scale, terms, stage=32)
        assert out.shape == (b, n, cv) and lse.shape == (b, n)
        errs[terms] = (float(np.abs(out - want_out).max()),
                       float(np.abs(lse - want_lse).max()))
    assert errs[3][0] <= 2e-4 and errs[3][1] <= 1e-4, errs
    assert errs[1][0] > 2e-4 and errs[1][1] > 1e-4, errs
