"""The port's CUDA kernels (the non-local attention forward K1-fwd, its
backward K1-dq, K1-dkv, each on wgmma where the dispatch sends bf16 (the
wide programs of all three at layer 3's C = Cv = 512), K1-fwd, K1-dq and
K1-dkv in f32 up to C, Cv = 512 (on TF32 wgmma, tf32_wgmma, held to the
tf32x3 programs too), and
the fused bottleneck tail K2) against their plain PyTorch versions, on a
card; K1-fwd and K2 through their registered operators, and
``torch.export`` on the card recording them; and each factory of the rest
of the 2D zoo built there, its bf16 forward held to its f32 one.

Every test here is marked ``gpu`` and skips without CUDA. The file imports
no JAX, so it runs on a machine that has only PyTorch (the suite's
conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pretorched_tpu_torch.ops import fused_block as fb
from pretorched_tpu_torch.ops.cuda import build
from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

# SAGAN attention in BigGAN at 64 px (keys pooled 2x2, Cv = 4 C):
# biggan256 ch 96, biggan128 ch 96 (C = 48) and the golden lock's ch 16
SAGAN_CASES = [
    (2, 4096, 1024, 96, 384, 1.0),
    (2, 4096, 1024, 48, 192, 1.0),
    (2, 4096, 1024, 16, 64, 1.0),
]
# (B, N, Nk, C, Cv, scale), as in test_torch_nonlocal_attention.py, plus
# gaussian mode's wide C with a wide Cv, C not a multiple of 8, and a C and
# Cv (one not a multiple of 8) too wide for the backward's resident rows
CASES = [
    (1, 256, 256, 32, 32, 1.0),
    (2, 300, 300, 32, 32, 1.0),
    (2, 300, 72, 32, 32, 0.5),
    (2, 300, 72, 16, 64, 1.0),
    (3, 200, 200, 16, 16, 0.25),
    (2, 130, 520, 8, 24, 2.0),
    (2, 1000, 125, 1024, 512, 1.0),
    (2, 100, 90, 20, 150, 1.0),
    (1, 150, 100, 392, 260, 1.0),
] + SAGAN_CASES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,tol_out,tol_lse', [
    (torch.float32, 2e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize('b,n,nk,c,cv,scale', CASES)
def test_attention_kernel_matches_plain(cuda, dtype, tol_out, tol_lse,
                                        b, n, nk, c, cv, scale):
    """f32: kernel vs plain at f32 tolerance (TF32 off). bf16: the kernel on
    bf16 inputs vs the plain version in f32 on the same inputs."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(b, n, c) / c ** 0.25).to(cuda, dtype)
    k = torch.from_numpy(rng.randn(b, nk, c) / c ** 0.25).to(cuda, dtype)
    v = torch.from_numpy(rng.randn(b, nk, cv)).to(cuda, dtype)
    before = na.nonlocal_attention_cuda.launches
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_cuda.launches == before + 1
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float(), scale)
    assert out.dtype == dtype and out.shape == (b, n, cv)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=tol_out)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=tol_lse)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,programs', [
    (torch.bfloat16, ('wgmma_wide', 'wgmma', 'wgmma')),
    (torch.float32, ('tf32_wgmma',) * 3)])
def test_sagan_shapes_take_their_programs(cuda, dtype, programs):
    """C is no multiple of 64 at SAGAN's shapes, but a multiple of 8: bf16
    runs K1-fwd's wgmma programs on widths padded by TMA (biggan256's Cv =
    384 the wide one), f32 the tf32_wgmma one, one launch each."""
    for (b, n, nk, c, cv, _), program in zip(SAGAN_CASES, programs):
        q = torch.randn(b, n, c, device=cuda, dtype=dtype)
        k = torch.randn(b, nk, c, device=cuda, dtype=dtype)
        v = torch.randn(b, nk, cv, device=cuda, dtype=dtype)
        before = dict(na.nonlocal_attention_cuda.by_kernel)
        na.nonlocal_attention_cuda(q, k, v)
        assert {key: n - before[key] for key, n in
                na.nonlocal_attention_cuda.by_kernel.items()} == {
            p: int(p == program) for p in na.PROGRAMS}, (b, n, nk, c, cv)


@pytest.mark.gpu
def test_attention_kernel_takes_strided_views(cuda):
    """The non-local block hands over ``flatten(2).transpose(1, 2)`` views."""
    x = torch.randn(2, 32, 4, 6, 8, device=cuda, dtype=torch.bfloat16)
    q = x.flatten(2).transpose(1, 2)
    assert not q.is_contiguous()
    out, _ = na.nonlocal_attention_cuda(q, q, q)
    want = na.nonlocal_attention_reference(q.float(), q.float(), q.float())
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)


def _bwd_inputs(b, n, nk, c, cv, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, n, c) / c ** 0.25).to(device, dtype)
    k = torch.from_numpy(rng.randn(b, nk, c) / c ** 0.25).to(device, dtype)
    v = torch.from_numpy(rng.randn(b, nk, cv)).to(device, dtype)
    do = torch.from_numpy(rng.randn(b, n, cv)).to(device, dtype)
    return q, k, v, do


def _rel_err(got, want):
    return ((got.float() - want).abs().max() / want.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('b,n,nk,c,cv,scale', CASES)
def test_backward_kernels_match_plain(cuda, dtype, tol, b, n, nk, c, cv,
                                      scale):
    """dq, dk, dv of K1-dq and K1-dkv against the plain backward in f32 on
    the same inputs, out and lse; max error relative to the largest
    gradient. f32: tf32_wgmma (three TF32 products per f32 product; scalar
    FMAs at gaussian mode's C = 1024), sums in another order. bf16: ds and p are
    rounded to bf16 for the products, and the outputs are bf16."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, dtype, cuda)
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v, scale)
    out = out.to(dtype)
    got = na.nonlocal_attention_bwd_cuda(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    want = na.nonlocal_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(), scale)
    for g, w, x, name in zip(got, want, (q, k, v), ('dq', 'dk', 'dv')):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert _rel_err(g, w) <= tol, (name, _rel_err(g, w))


@pytest.mark.gpu
def test_gradient_through_strided_views(cuda):
    """The non-local block's ``flatten(2).transpose(1, 2)`` views, with a
    gradient: the Function runs K1-fwd, K1-dq and K1-dkv once each."""
    # q = k = x at unit-scale logits: with raw randn the diagonal's 32
    # dominates, p is one-hot and ds a difference of near-equal numbers
    x = (torch.randn(2, 32, 4, 6, 8, device=cuda) / 32 ** 0.5).to(
        torch.bfloat16).requires_grad_()
    y = torch.randn(2, 48, 4, 6, 8, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    q, v = x.flatten(2).transpose(1, 2), y.flatten(2).transpose(1, 2)
    assert not q.is_contiguous()
    ct = torch.randn(2, 4 * 6 * 8, 48, device=cuda)
    out = na.auto_nonlocal_attention(q, q, v)
    got = torch.autograd.grad((out.float() * ct).sum(), (x, y))
    xr, yr = (t.detach().float().requires_grad_() for t in (x, y))
    qr, vr = xr.flatten(2).transpose(1, 2), yr.flatten(2).transpose(1, 2)
    want = torch.autograd.grad(
        (na.nonlocal_attention_reference(qr, qr, vr) * ct).sum(), (xr, yr))
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 2e-2


@pytest.mark.gpu
def test_launch_counters_advance_once_per_backward(cuda):
    launches = (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
                na.nonlocal_attention_bwd_dkv_cuda)
    q, k, v, do = _bwd_inputs(2, 300, 72, 16, 24, torch.bfloat16, cuda)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = [f.launches for f in launches]
    out = na.auto_nonlocal_attention(q, k, v)
    assert [f.launches for f in launches] == [before[0] + 1, *before[1:]]
    out.backward(do)
    assert [f.launches for f in launches] == [b + 1 for b in before]
    with torch.no_grad():
        na.auto_nonlocal_attention(q, k, v)
    assert [f.launches for f in launches] == [before[0] + 2, before[1] + 1,
                                              before[2] + 1]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_launch_spans_carry_device_time(cuda, dtype):
    """Under a profiler each K1 and K2 launch is a span
    (``utils.profiling``) with positive device ms. K1-dq and K1-dkv run on
    autograd's device thread, and take the span that the caller of
    ``backward`` holds open as their parent."""
    from torch.profiler import ProfilerActivity, profile

    from pretorched_tpu_torch.utils import profiling

    q, k, v, do = _bwd_inputs(2, 1024, 1024, 64, 64, dtype, cuda)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    tail = _k2_inputs(K2_CASES[0], dtype, cuda)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.span('test.fwd'):
            out = na.auto_nonlocal_attention(q, k, v)
        with profiling.span('test.bwd'):
            out.backward(do)
        with torch.no_grad():
            fb.fused_bottleneck_tail(*tail)
    got = profiling.recorded()
    profiling.reset()
    for name in ('k1.fwd', 'k1.dq', 'k1.dkv', 'k2.tail'):
        assert len(got[name]['device_ms']) == 1, name
        assert got[name]['device_ms'][0] > 0, name
    assert got['k1.fwd']['parent'] == 'test.fwd'
    assert got['k1.dq']['parent'] == got['k1.dkv']['parent'] == 'test.bwd'
    bwd = got['test.bwd']
    assert 0 <= bwd['self_device_ms'][0] < bwd['device_ms'][0]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv,scale', CASES)
def test_f32_backward_programs_match_plain_and_scalar(cuda, b, n, nk, c, cv,
                                                      scale):
    """f32 K1-dq and K1-dkv on the program the dispatch picks (tf32_wgmma
    up to C, Cv = 512, scalar past it), one launch each counted under it;
    against the plain backward at 1e-4 of the largest gradient, against the
    scalar program at the same inputs within the same, and bitwise the same
    on a second run (no atomics)."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, torch.float32, cuda)
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v, scale)
    delta = (do * out).sum(-1)
    program = 'tf32_wgmma' if max(c, cv) <= 512 else 'scalar'
    for op in ('dq', 'dkv'):
        assert na.attention_kernel(torch.float32, c, cv, op) == program
    fns = (na.nonlocal_attention_bwd_dq_cuda, na.nonlocal_attention_bwd_dkv_cuda)
    before = [dict(fn.by_kernel) for fn in fns]
    dq = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale)
    dk, dv = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    for fn, was in zip(fns, before):
        assert {p: fn.by_kernel[p] - was[p] for p in na.PROGRAMS} == {
            p: int(p == program) for p in na.PROGRAMS}
    want = na.nonlocal_attention_bwd_reference(q, k, v, out, lse, do, scale)
    scalar = (na._launch_dq(q, k, v, do, lse, delta, scale, 'scalar'),
              *na._launch_dkv(q, k, v, do, lse, delta, scale, 'scalar'))
    again = (na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale),
             *na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 scale))
    torch.cuda.synchronize()
    for g, w, old, rep, x, name in zip((dq, dk, dv), want, scalar, again,
                                       (q, k, v), ('dq', 'dk', 'dv')):
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        assert _rel_err(g, w) <= 1e-4, (name, _rel_err(g, w))
        assert _rel_err(g, old) <= 1e-4, (name, _rel_err(g, old))
        assert torch.equal(g, rep), name


# tf32x3's per-row and per-width guards: B = 3 with each batch item's
# logits on another scale (lse and delta read per row of each item), Cv
# above and below C, ragged N and Nk
TF32X3_GUARD_CASES = [(3, 200, 150, 64, 192), (3, 150, 200, 192, 64),
                      (3, 333, 65, 40, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', TF32X3_GUARD_CASES)
def test_tf32x3_reads_lse_per_row_and_sizes_by_cv(cuda, b, n, nk, c, cv):
    """The tf32x3 programs at B > 1 with batch items whose softmax rows
    differ in scale (a wrong item's lse or delta would move every
    gradient), with v, do and dv sized by Cv, not C: each gradient within
    1e-4 of the plain backward's largest, each batch item on its own."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, torch.float32, cuda, seed=3)
    q = q * torch.arange(1, b + 1, device=cuda, dtype=q.dtype)[:, None, None]
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
    delta = (do * out).sum(-1)
    dq = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    dk, dv = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    want = na.nonlocal_attention_bwd_reference(q, k, v, out, lse, do)
    for i in range(b):
        for g, w, name in zip((dq, dk, dv), want, ('dq', 'dk', 'dv')):
            assert _rel_err(g[i], w[i]) <= 1e-4, (i, name)


@pytest.mark.gpu
def test_f32_layer_shapes_take_tf32x3(cuda):
    """The non-local model's layer-2 and layer-3 shapes in f32 (B = 1):
    K1-fwd, K1-dq and K1-dkv on tf32_wgmma, one launch each through the
    autograd Function."""
    fns = (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
           na.nonlocal_attention_bwd_dkv_cuda)
    for n, c in ((6272, 256), (784, 512)):
        q, k, v, do = _bwd_inputs(1, n, n, c, c, torch.float32, cuda)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        before = [dict(fn.by_kernel) for fn in fns]
        na.auto_nonlocal_attention(q, k, v).backward(do)
        torch.cuda.synchronize()
        for fn, was, kernel in zip(fns, before, ('tf32_wgmma',) * 3):
            assert {key: fn.by_kernel[key] - was[key]
                    for key in fn.by_kernel} == {
                key: int(key == kernel) for key in na.PROGRAMS}


# tf32_wgmma at small train-like shapes: B = 3 with rows of each item on
# another scale, Cv above and below C, N no multiple of 64, N != Nk, the
# widths of layer 2 (256) and layer 3 (512, two column chunks a part), and
# widths no multiple of 64 (the pre-pass pads them)
TF32_WGMMA_CASES = [
    (3, 200, 150, 64, 192, 1.0), (3, 150, 200, 192, 64, 1.0),
    (3, 333, 65, 40, 24, 0.5), (2, 300, 300, 256, 256, 1.0),
    (2, 196, 100, 512, 512, 1.0), (2, 130, 257, 512, 128, 1.0),
    (1, 97, 64, 320, 96, 1.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv,scale', TF32_WGMMA_CASES)
def test_tf32_wgmma_matches_plain_and_tf32x3(cuda, b, n, nk, c, cv, scale):
    """f32 K1-dq and K1-dkv on tf32_wgmma, one launch each counted under
    it: each batch item's dq, dk, dv within 1e-4 of the plain backward's
    largest (a wrong item's lse or delta would move them), within the same
    of the mma.sync tf32x3 program at the same inputs, bitwise the same on
    a second run (no atomics); its scratch as large as the C entry lays
    it out."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, torch.float32, cuda, seed=4)
    q = q * torch.arange(1, b + 1, device=cuda, dtype=q.dtype)[:, None, None]
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v, scale)
    delta = (do * out).sum(-1)
    lib = build.load_library()
    for dkv in (False, True):
        assert na.tf32_wgmma_scratch_bytes(dkv, b, n, nk, c, cv) == (
            lib.pt_nonlocal_attention_bwd_tf32_wgmma_scratch(
                int(dkv), b, n, nk, c, cv))
    fns = (na.nonlocal_attention_bwd_dq_cuda, na.nonlocal_attention_bwd_dkv_cuda)
    before = [dict(fn.by_kernel) for fn in fns]
    got = (na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale),
           *na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, scale))
    torch.cuda.synchronize()
    for fn, was in zip(fns, before):
        assert {p: fn.by_kernel[p] - was[p] for p in na.PROGRAMS} == {
            p: int(p == 'tf32_wgmma') for p in na.PROGRAMS}
    want = na.nonlocal_attention_bwd_reference(q, k, v, out, lse, do, scale)
    older = (na._launch_dq(q, k, v, do, lse, delta, scale, 'tf32x3'),
             *na._launch_dkv(q, k, v, do, lse, delta, scale, 'tf32x3'))
    again = (na._launch_dq(q, k, v, do, lse, delta, scale, 'tf32_wgmma'),
             *na._launch_dkv(q, k, v, do, lse, delta, scale, 'tf32_wgmma'))
    torch.cuda.synchronize()
    for g, w, old, rep, x, name in zip(got, want, older, again, (q, k, v),
                                       ('dq', 'dk', 'dv')):
        assert g.shape == x.shape and g.dtype == torch.float32, name
        assert torch.equal(g, rep), name
        assert _rel_err(g, old) <= 1e-4, (name, _rel_err(g, old))
        for i in range(b):
            assert _rel_err(g[i], w[i]) <= 1e-4, (name, i, _rel_err(g[i], w[i]))


# f32 K1-fwd beyond CASES: small train-like shapes (layer 2 at 4 frames,
# layer 3 at 8), MNIST's two blocks, a ragged N and Nk with Cv above and
# below C, odd widths (Cv odd: scalar stores)
F32_FWD_CASES = [
    (2, 784, 784, 256, 256, 1.0),
    (2, 196, 196, 512, 512, 1.0),
    (8, 196, 196, 16, 16, 1.0),
    (8, 49, 49, 32, 32, 1.0),
    (3, 333, 65, 40, 24, 1.0),
    (2, 77, 33, 7, 5, 1.0),
    (2, 100, 90, 20, 151, 0.5),
]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv,scale', CASES + F32_FWD_CASES)
def test_f32_forward_program_matches_plain_and_scalar(cuda, b, n, nk, c, cv,
                                                      scale):
    """f32 K1-fwd on the program the dispatch picks (tf32_wgmma up to C,
    Cv = 512, scalar past it), one launch counted under it; out within 2e-4
    and lse within 1e-4 of the plain version and of the scalar program at
    the same inputs, and bitwise the same on a second run."""
    q, k, v, _ = _bwd_inputs(b, n, nk, c, cv, torch.float32, cuda)
    program = 'tf32_wgmma' if max(c, cv) <= 512 else 'scalar'
    assert na.attention_kernel(torch.float32, c, cv, 'fwd') == program
    fn = na.nonlocal_attention_cuda
    before = dict(fn.by_kernel)
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert {p: fn.by_kernel[p] - before[p] for p in na.PROGRAMS} == {
        p: int(p == program) for p in na.PROGRAMS}
    assert out.shape == (b, n, cv) and lse.shape == (b, n)
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(q, k, v, scale)
    old, old_lse = na._launch_fwd(q, k, v, scale, 'scalar')
    again, again_lse = na.nonlocal_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    for ref, ref_lse in ((want, want_lse), (old, old_lse)):
        torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', TF32X3_GUARD_CASES)
def test_tf32x3_forward_reads_rows_per_item_and_sizes_by_cv(cuda, b, n, nk,
                                                            c, cv):
    """The f32 K1-fwd at B > 1 with batch items whose logits differ in
    scale (a row of another item would move every out and lse), with v and
    out sized by Cv, not C: each item on its own within 2e-4 (out) and 1e-4
    (lse) of the plain version."""
    q, k, v, _ = _bwd_inputs(b, n, nk, c, cv, torch.float32, cuda, seed=3)
    q = q * torch.arange(1, b + 1, device=cuda, dtype=q.dtype)[:, None, None]
    out, lse = na.nonlocal_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == (b, n, cv) and lse.shape == (b, n)
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
    for i in range(b):
        torch.testing.assert_close(out[i], want[i], rtol=0, atol=2e-4)
        torch.testing.assert_close(lse[i], want_lse[i], rtol=0, atol=1e-4)


# the f32 K1-fwd on tf32_wgmma: B = 3 with each item's rows on another
# scale (its lse per row of each item), Cv above and below C (out sized by
# Cv), ragged N and Nk, N != Nk both ways, layer 3's 512 (two grid.z parts)
# and SAGAN's 96 / 384 (two parts of 192), widths off 64 and off 32 (the
# pre-pass pads them), odd Cv (element stores), one key tile
TF32_WGMMA_FWD_CASES = [
    (3, 200, 150, 64, 192, 1.0), (3, 150, 200, 192, 64, 1.0),
    (3, 333, 65, 40, 24, 0.5), (2, 300, 300, 256, 256, 1.0),
    (2, 196, 100, 512, 512, 1.0), (2, 130, 257, 512, 128, 1.0),
    (2, 257, 130, 96, 384, 1.0), (1, 97, 64, 320, 96, 1.0),
    (2, 77, 33, 7, 5, 2.0), (2, 100, 90, 20, 151, 1.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv,scale', TF32_WGMMA_FWD_CASES)
def test_tf32_wgmma_forward_matches_plain_and_tf32x3(cuda, b, n, nk, c, cv,
                                                     scale):
    """f32 K1-fwd on tf32_wgmma, one launch counted under it: each batch
    item's out within 2e-4 and lse within 1e-4 of the plain version (a row
    of another item would move them), the same of the mma.sync tf32x3
    program at the same inputs, bitwise the same on a second run; its
    scratch as large as the C entry lays it out."""
    q, k, v, _ = _bwd_inputs(b, n, nk, c, cv, torch.float32, cuda, seed=5)
    q = q * torch.arange(1, b + 1, device=cuda, dtype=q.dtype)[:, None, None]
    assert na.attention_kernel(torch.float32, c, cv, 'fwd') == 'tf32_wgmma'
    assert na.tf32_wgmma_fwd_scratch_bytes(b, n, nk, c, cv) == (
        build.load_library().pt_nonlocal_attention_fwd_tf32_wgmma_scratch(
            b, n, nk, c, cv))
    fn = na.nonlocal_attention_cuda
    before = dict(fn.by_kernel)
    out, lse = na.nonlocal_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert {p: fn.by_kernel[p] - before[p] for p in na.PROGRAMS} == {
        p: int(p == 'tf32_wgmma') for p in na.PROGRAMS}
    assert out.shape == (b, n, cv) and lse.shape == (b, n)
    assert out.dtype == lse.dtype == torch.float32
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(q, k, v, scale)
    old, old_lse = na._launch_fwd(q, k, v, scale, 'tf32x3')
    again, again_lse = na._launch_fwd(q, k, v, scale, 'tf32_wgmma')
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, again_lse)
    torch.testing.assert_close(out, old, rtol=0, atol=2e-4)
    torch.testing.assert_close(lse, old_lse, rtol=0, atol=1e-4)
    for i in range(b):
        torch.testing.assert_close(out[i], want[i], rtol=0, atol=2e-4)
        torch.testing.assert_close(lse[i], want_lse[i], rtol=0, atol=1e-4)


# (B, N, Nk, C, Cv) for the wgmma kernels (bf16, C and Cv multiples of 64 up
# to 256): the smallest shape; ragged N and Nk with B >= 2, so a tile
# crosses a batch boundary; Cv != C both ways (Cv = 128 and 192 take
# m64n64k16 chunks, Cv = 256 one m64n256k16); sub_sample and layer 2 of
# the slice at B = 2
WGMMA_CASES = [
    (1, 64, 64, 64, 64),
    (3, 1000, 1000, 64, 64),
    (2, 300, 200, 64, 64),
    (2, 130, 520, 64, 128),
    (2, 300, 72, 64, 256),
    (1, 100, 90, 256, 64),
    (2, 1000, 1000, 128, 192),
    (2, 6272, 784, 256, 256),
    (2, 6272, 6272, 256, 256),
    (2, 3136, 6272, 256, 256),      # layer 2, one of 2 time shards
]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', WGMMA_CASES)
def test_wgmma_forward_matches_plain(cuda, b, n, nk, c, cv):
    """K1-fwd's wgmma kernel on bf16 inputs vs the plain version in f32 on
    the same inputs (out 2e-2, lse 1e-2, as for the mma.sync kernel; out
    also within 2e-2 of the largest |out|, since at Nk = 6272 |out| is
    itself ~0.02 and the absolute limit alone would pass a dropped tile)."""
    q, k, v, _ = _bwd_inputs(b, n, nk, c, cv, torch.bfloat16, cuda)
    before = na.nonlocal_attention_cuda.by_kernel['wgmma']
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_cuda.by_kernel['wgmma'] == before + 1
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, cv)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)
    assert _rel_err(out, want) <= 2e-2
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', WGMMA_CASES)
def test_wgmma_dkv_matches_plain(cuda, b, n, nk, c, cv):
    """K1-dkv's wgmma kernel against the plain backward in f32 (max error
    over the largest gradient, 2e-2, as for the generic kernel), and
    bitwise the same on a second run (no atomics)."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, torch.bfloat16, cuda)
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
    out = out.to(torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1)
    before = na.nonlocal_attention_bwd_dkv_cuda.by_kernel['wgmma']
    dk, dv = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    again = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_bwd_dkv_cuda.by_kernel['wgmma'] == before + 2
    _, want_dk, want_dv = na.nonlocal_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float())
    for g, w, x in ((dk, want_dk, k), (dv, want_dv, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        assert _rel_err(g, w) <= 2e-2
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', WGMMA_CASES)
def test_wgmma_dq_matches_plain(cuda, b, n, nk, c, cv):
    """K1-dq's wgmma kernel against the plain backward in f32: max error
    within 2e-2 of the largest |dq| (ds is rounded to bf16 for its product
    and dq is stored in bf16, as in the generic kernel; relative to the
    largest output because |dq| is small at large Nk and an absolute limit
    would pass a dropped k tile), and bitwise the same on a second run (no
    atomics)."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, torch.bfloat16, cuda)
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
    out = out.to(torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1)
    before = na.nonlocal_attention_bwd_dq_cuda.by_kernel['wgmma']
    dq = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    again = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_bwd_dq_cuda.by_kernel['wgmma'] == before + 2
    want_dq = na.nonlocal_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float())[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert _rel_err(dq, want_dq) <= 2e-2
    assert torch.equal(dq, again)


@pytest.mark.gpu
def test_layer2_shapes_take_the_wgmma_kernels(cuda):
    """The non-local model's layer-2 shapes (reduced B) go to the wgmma
    kernels; at layer 3's K1-fwd, K1-dq and K1-dkv take their wide wgmma
    programs (counted as ``wgmma_wide``), by the counters of K1-fwd, K1-dq
    and K1-dkv."""
    fns = (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
           na.nonlocal_attention_bwd_dkv_cuda)
    for (n, c), kernels in (((6272, 256), ('wgmma', 'wgmma', 'wgmma')),
                            ((784, 512), ('wgmma_wide',) * 3)):
        q, k, v, do = _bwd_inputs(1, n, n, c, c, torch.bfloat16, cuda)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        before = [dict(fn.by_kernel) for fn in fns]
        na.auto_nonlocal_attention(q, k, v).backward(do)
        torch.cuda.synchronize()
        for fn, was, kernel in zip(fns, before, kernels):
            assert {key: fn.by_kernel[key] - was[key]
                    for key in fn.by_kernel} == {
                key: int(key == kernel) for key in na.PROGRAMS}


# (B, N, Nk, C, Cv) for the wide wgmma programs of K1-fwd, K1-dq and K1-dkv
# (bf16, C and Cv multiples of 64 up to 512, one above 256): layer 3 of the
# slice at B = 1 and 8; sub_sample's 784 x 196; ragged N and Nk with C !=
# Cv both ways (384 / 320 and 320 / 512: 3 and 4 chunks a half; K1-dq's
# consumer 1 owns 3 and 2 of 3 chunks); one side narrow (Cv = 64: consumer
# 1's O chunk and dv's second half do not exist; C = 64 with Cv = 384: K1-dq's
# consumer 1 owns no chunk)
WIDE_CASES = [
    (1, 784, 784, 512, 512),
    (8, 784, 784, 512, 512),
    (2, 784, 196, 512, 512),
    (2, 1000, 1000, 384, 320),
    (2, 300, 200, 320, 512),
    (1, 100, 90, 512, 64),
    (1, 130, 250, 64, 384),
    (2, 392, 784, 512, 512),        # layer 3, one of 2 time shards
]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', WIDE_CASES)
def test_wide_wgmma_forward_matches_plain(cuda, b, n, nk, c, cv):
    """K1-fwd's wide wgmma program against the plain version in f32 on the
    same bf16 inputs, at the wgmma tolerances: out 2e-2, and 2e-2 of the
    largest |out|; lse 1e-2."""
    q, k, v, _ = _bwd_inputs(b, n, nk, c, cv, torch.bfloat16, cuda)
    before = na.nonlocal_attention_cuda.by_kernel['wgmma_wide']
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_cuda.by_kernel['wgmma_wide'] == before + 1
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, cv)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)
    assert _rel_err(out, want) <= 2e-2
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', WIDE_CASES)
def test_wide_wgmma_dkv_matches_plain(cuda, b, n, nk, c, cv):
    """K1-dkv's wide wgmma program against the plain backward in f32 (max
    error within 2e-2 of the largest gradient), and bitwise the same on a
    second run (no atomics)."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, torch.bfloat16, cuda)
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
    out = out.to(torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1)
    before = na.nonlocal_attention_bwd_dkv_cuda.by_kernel['wgmma_wide']
    dk, dv = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    again = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (na.nonlocal_attention_bwd_dkv_cuda.by_kernel['wgmma_wide']
            == before + 2)
    _, want_dk, want_dv = na.nonlocal_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float())
    for g, w, x in ((dk, want_dk, k), (dv, want_dv, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        assert _rel_err(g, w) <= 2e-2
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', WIDE_CASES)
def test_wide_wgmma_dq_matches_plain(cuda, b, n, nk, c, cv):
    """K1-dq's wide wgmma program against the plain backward in f32 (max
    error within 2e-2 of the largest |dq|), bitwise the same on a second
    run (no atomics), counted as ``wgmma_wide``."""
    q, k, v, do = _bwd_inputs(b, n, nk, c, cv, torch.bfloat16, cuda)
    out, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
    out = out.to(torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1)
    before = na.nonlocal_attention_bwd_dq_cuda.by_kernel['wgmma_wide']
    dq = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    again = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (na.nonlocal_attention_bwd_dq_cuda.by_kernel['wgmma_wide']
            == before + 2)
    want_dq = na.nonlocal_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float())[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert _rel_err(dq, want_dq) <= 2e-2
    assert torch.equal(dq, again)


@pytest.mark.gpu
@pytest.mark.parametrize('b', [1, 8])
def test_wide_wgmma_agrees_with_the_mma_sync_kernels(cuda, b):
    """At layer 3 (C = Cv = 512, N = Nk = 784) the wide wgmma programs of
    K1-fwd, K1-dq and K1-dkv and the mma.sync kernels they replaced
    (through the private launch routes) compute the same function."""
    q, k, v, do = _bwd_inputs(b, 784, 784, 512, 512, torch.bfloat16, cuda)
    ow, lw = na.nonlocal_attention_cuda(q, k, v)
    om, lm = na._launch_fwd(q, k, v, 1.0, 'mma_sync')
    assert _rel_err(ow, om.float()) <= 2e-2
    torch.testing.assert_close(lw, lm, rtol=0, atol=1e-2)
    delta = (do.float() * om.float()).sum(-1)
    gw = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lm, delta)
    gm = na._launch_dkv(q, k, v, do, lm, delta, 1.0, 'mma_sync')
    for a, m in zip(gw, gm):
        assert _rel_err(a, m.float()) <= 2e-2
    dqw = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lm, delta)
    dqm = na._launch_dq(q, k, v, do, lm, delta, 1.0, 'mma_sync')
    assert _rel_err(dqw, dqm.float()) <= 2e-2


@pytest.mark.gpu
def test_wgmma_agrees_with_the_mma_sync_kernels(cuda):
    """At layer 2's widths the wgmma kernels and the kernels they replaced
    compute the same function (the replaced ones through the wrappers'
    private launch routes)."""
    q, k, v, do = _bwd_inputs(2, 1000, 700, 256, 256, torch.bfloat16, cuda)
    ow, lw = na.nonlocal_attention_cuda(q, k, v)
    om, lm = na._launch_fwd(q, k, v, 1.0, 'mma_sync')
    assert _rel_err(ow, om.float()) <= 2e-2
    torch.testing.assert_close(lw, lm, rtol=0, atol=1e-2)
    delta = (do.float() * om.float()).sum(-1)
    gw = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lm, delta)
    gm = na._launch_dkv(q, k, v, do, lm, delta, 1.0, 'mma_sync')
    for a, b in zip(gw, gm):
        assert _rel_err(a, b.float()) <= 2e-2
    dqw = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lm, delta)
    dqm = na._launch_dq(q, k, v, do, lm, delta, 1.0, 'mma_sync')
    assert _rel_err(dqw, dqm.float()) <= 2e-2


# (B, N, Nk, C, Cv) for K1-fwd's wgmma programs at widths that are no
# multiple of 64, padded to whole 64-channel boxes by TMA's zero fill: each
# C of {8, 16, 24, 48, 96, 136, 200} and each Cv of {8, 40, 64, 192, 384,
# 264}; ragged N and Nk (the last query band and key tile partly past the
# tensor, rows and columns at once); B = 1 and B > 1 (a box never reads
# the next batch item, lse shaped per row); Cv != C both ways (out sized by
# Cv). Cv = 384 and 264 (Cvp = 320: consumer 1's third chunk does not
# exist) take the wide program.
NARROW_CASES = [
    (1, 64, 64, 8, 8),
    (2, 300, 200, 16, 64),
    (3, 1000, 250, 24, 40),
    (2, 4096, 1024, 48, 192),
    (2, 1000, 520, 96, 384),
    (1, 130, 90, 136, 264),
    (2, 200, 130, 200, 8),
    (1, 100, 300, 8, 384),
    (2, 777, 333, 136, 40),
    (4, 49, 49, 32, 32),
]


@pytest.mark.gpu
@pytest.mark.parametrize('b,n,nk,c,cv', NARROW_CASES)
def test_narrow_wgmma_forward_matches_plain(cuda, b, n, nk, c, cv):
    """K1-fwd's wgmma programs at padded widths against the plain version
    in f32 on the same bf16 inputs (out 2e-2, and 2e-2 of the largest
    |out|; lse 1e-2) and against the mma.sync program they replaced there
    (the private launch route), one launch each on its program."""
    q, k, v, _ = _bwd_inputs(b, n, nk, c, cv, torch.bfloat16, cuda)
    program = na._program(na.attention_kernel(q.dtype, c, cv, 'fwd'), c, cv)
    assert program == ('wgmma_wide' if max(c, cv) > 256 else 'wgmma')
    before = dict(na.nonlocal_attention_cuda.by_kernel)
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v)
    om, lm = na._launch_fwd(q, k, v, 1.0, 'mma_sync')
    torch.cuda.synchronize()
    after = na.nonlocal_attention_cuda.by_kernel
    assert {p: after[p] - before[p] for p in na.PROGRAMS} == {
        p: int(p in (program, 'mma_sync')) for p in na.PROGRAMS}
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, cv)
    assert lse.dtype == torch.float32 and lse.shape == (b, n)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)
    assert _rel_err(out, want) <= 2e-2
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-2)
    assert _rel_err(out, om.float()) <= 2e-2
    torch.testing.assert_close(lse, lm, rtol=0, atol=1e-2)


@pytest.mark.gpu
def test_narrow_widths_off_the_step_take_mma_sync(cuda):
    """C = 20 is no multiple of 8 (TMA's 16-byte rows): K1-fwd stays on
    the mma.sync program, held to the plain version."""
    q, k, v, _ = _bwd_inputs(2, 100, 90, 20, 64, torch.bfloat16, cuda)
    assert na.attention_kernel(q.dtype, 20, 64, 'fwd') == 'mma_sync'
    before = na.nonlocal_attention_cuda.by_kernel['mma_sync']
    out, lse = na.nonlocal_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_cuda.by_kernel['mma_sync'] == before + 1
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-2)


@pytest.mark.gpu
def test_wgmma_kernels_refuse_misaligned_tensors(cuda):
    """TMA needs a 16-byte aligned base: a view 2 bytes into its storage is
    refused, not copied."""
    flat = torch.randn(1 * 64 * 64 + 1, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(1, 64, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match='16-byte aligned'):
        na.nonlocal_attention_cuda(q, q, q)
    lse = torch.zeros(1, 64, device=cuda)
    before = na.nonlocal_attention_bwd_dq_cuda.launches
    with pytest.raises(ValueError, match='16-byte aligned'):
        na.nonlocal_attention_bwd_dq_cuda(q, q, q, q, lse, lse)
    assert na.nonlocal_attention_bwd_dq_cuda.launches == before
    # the wide programs too (C = 320)
    wide = torch.randn(64 * 320 + 1, device=cuda).to(torch.bfloat16)
    q = wide[1:].view(1, 64, 320)
    before = (na.nonlocal_attention_bwd_dq_cuda.launches,
              na.nonlocal_attention_bwd_dkv_cuda.launches)
    with pytest.raises(ValueError, match='16-byte aligned'):
        na.nonlocal_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match='16-byte aligned'):
        na.nonlocal_attention_bwd_dq_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match='16-byte aligned'):
        na.nonlocal_attention_bwd_dkv_cuda(q, q, q, q, lse, lse)
    assert (na.nonlocal_attention_bwd_dq_cuda.launches,
            na.nonlocal_attention_bwd_dkv_cuda.launches) == before
    # K1-fwd at padded widths (C = 48, Cv = 192; C = 96, Cv = 384)
    for c, cv in ((48, 192), (96, 384)):
        flat = torch.randn(64 * cv + 1, device=cuda).to(torch.bfloat16)
        v = flat[1:].view(1, 64, cv)
        q = torch.randn(1, 64, c, device=cuda).to(torch.bfloat16)
        before = dict(na.nonlocal_attention_cuda.by_kernel)
        with pytest.raises(ValueError, match='16-byte aligned'):
            na.nonlocal_attention_cuda(q, q, v)
        assert na.nonlocal_attention_cuda.by_kernel == before


@pytest.mark.gpu
def test_remat_updates_bn_stats_once_on_cuda(cuda):
    """On a card the checkpoint recompute runs on the autograd engine's
    thread; BN must still skip its running-statistics update there."""
    from pretorched_tpu_torch.models.nonlocalnet import NonLocalResNet3D

    model = NonLocalResNet3D(block='basic', layers=(1, 1, 1, 1),
                             num_classes=5, nonlocal_layers=(0, 1, 1, 0),
                             remat=(0, 1)).to(cuda).train()
    x = torch.randn(2, 3, 4, 32, 32, device=cuda)
    model(x).sum().backward()
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            assert int(m.num_batches_tracked) == 1, name
    assert model.layer1[0].conv1.weight.grad is not None


# K2: (N, T, H, W, Cin, Cm, Cout, projection): SlowFast-R50's fast pathway
# at fused_blocks=32 on 20 clips x 64 frames x 224 px, one shape of
# fused_blocks=64 with a wide projection (too wide for the tensor-core
# path's shared memory: bf16 takes the CUDA-core path), an odd case, and
# channel counts that are no multiple of 8 (the CUDA-core path again)
K2_CASES = [
    (20, 32, 56, 56, 8, 8, 32, True),
    (20, 32, 56, 56, 32, 8, 32, False),
    (20, 32, 28, 28, 64, 16, 64, False),
    (20, 32, 14, 14, 128, 32, 128, False),
    (2, 4, 56, 56, 80, 64, 256, True),
    (1, 3, 7, 7, 64, 16, 64, False),
    (2, 3, 9, 300, 24, 20, 40, True),      # W > 256 threads, ragged chunks
]


def _k2_inputs(case, dtype, device, seed=0):
    n, t, h, w, cin, cm, cout, proj = case
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    def affine(c):
        return torch.stack([torch.rand(c, generator=g) + 0.5,
                            torch.rand(c, generator=g) * 0.4 - 0.2]).to(device)

    y1 = rand(n, cm, t, h, w).relu_().to(dtype)
    x = rand(n, cin, t, h, w).relu_().to(dtype)
    return (y1, x, rand(cm, cm, 3, 3, scale=(2 / (9 * cm)) ** 0.5),
            affine(cm), rand(cout, cm, scale=(2 / cm) ** 0.5), affine(cout),
            rand(cout, cin, scale=(2 / cin) ** 0.5) if proj else None,
            affine(cout) if proj else None)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('case', K2_CASES)
def test_fused_tail_kernel_matches_plain(cuda, dtype, tol, case):
    """max |out - plain| / max |plain|. f32: the same f32 products, summed
    in another order (TF32 off for the plain convs). bf16: both round y2
    and the output to bf16; a sum near a rounding boundary lands one bf16
    step apart."""
    args = _k2_inputs(case, dtype, cuda)
    before = fb_cuda.fused_bottleneck_tail_cuda.launches
    with torch.no_grad():
        out = fb.fused_bottleneck_tail(*args)
        torch.cuda.synchronize()
        assert fb_cuda.fused_bottleneck_tail_cuda.launches == before + 1
        want = fb.fused_bottleneck_tail_reference(*args)
    n, t, h, w, cin, cm, cout, proj = case
    assert out.dtype == dtype and out.shape == (n, cout, t, h, w)
    assert _rel_err(out, want.float()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize('case', K2_CASES[:4])
def test_fused_tail_slice_shapes_take_the_tensor_cores(cuda, case):
    """bf16 at the slice's shapes goes to the tensor cores (res2 and res3
    to the TMA kernel, res4 to mma.sync); f32 to the CUDA-core one."""
    bf16 = 'mma_sync' if case[6] > 64 else 'tma'
    for dtype, kernel in ((torch.bfloat16, bf16),
                          (torch.float32, 'cuda_cores')):
        args = _k2_inputs(case, dtype, cuda)
        with torch.no_grad():
            p = fb_cuda.prepare_tail(*args)
        assert p['kernel'] == kernel


# K2's TMA kernel: chip_smoke.py's eight phase-8 shapes (N, T, H, W, Cin,
# Cm, Cout, projection) with the kernel the dispatch gives each, then a
# ragged last tile (H = 29 in tiles of 6 rows), frames that start off the
# 16-byte grid (7 x 6 = 42 pixels), a projection on a frame narrower than a
# TMA box, and a tiny input with fewer tiles than blocks. Fast res4 (Cout =
# 128) stays on the mma.sync kernel, which is faster there
K2_TMA_CASES = [
    ((20, 32, 56, 56, 8, 8, 32, True), 'tma'),
    ((20, 32, 56, 56, 32, 8, 32, False), 'tma'),
    ((20, 32, 28, 28, 64, 16, 64, False), 'tma'),
    ((20, 32, 14, 14, 128, 32, 128, False), 'mma_sync'),
    ((20, 32, 7, 7, 256, 64, 256, False), 'mma_sync'),
    ((20, 4, 56, 56, 80, 64, 256, True), 'cuda_cores'),
    ((20, 4, 56, 56, 256, 64, 256, False), 'mma_sync'),
    ((1, 3, 7, 7, 64, 16, 64, False), 'mma_sync'),
    ((2, 5, 29, 32, 16, 8, 32, True), 'tma'),
    ((3, 8, 7, 6, 32, 16, 32, False), 'tma'),
    ((1, 8, 5, 24, 24, 8, 24, True), 'tma'),
    ((1, 1, 8, 8, 16, 16, 16, False), 'tma'),
]


def _rel_to_max(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize('case,kernel', K2_TMA_CASES)
def test_fused_tail_tma_kernel_matches_plain(cuda, case, kernel):
    """bf16 through the kernel the dispatch picks against the plain version
    on the same inputs: max error within 2e-2 of the largest |out| (both
    round y2 and the output to bf16, so an element near a rounding boundary
    lands one bf16 step, 2^-8 relative, apart), and bitwise the same on a
    second run. The slice's shapes give the TMA kernel thousands of tiles,
    many per persistent block (each block walks both ring slots many
    times); the last case one tile, fewer than blocks."""
    args = _k2_inputs(case, torch.bfloat16, cuda)
    with torch.no_grad():
        p = fb_cuda.prepare_tail(*args)
        assert p['kernel'] == kernel
        before = dict(fb_cuda.fused_bottleneck_tail_cuda.by_kernel)
        out = fb_cuda.launch_tail(p).clone()
        assert fb_cuda.fused_bottleneck_tail_cuda.by_kernel[kernel] == \
            before[kernel] + 1
        want = fb.fused_bottleneck_tail_reference(*args)
        torch.cuda.synchronize()
        assert _rel_to_max(out, want) <= 2e-2
        again = fb_cuda.launch_tail(p)
        torch.cuda.synchronize()
        assert torch.equal(again, out)


@pytest.mark.gpu
@pytest.mark.parametrize('case', [c for c, k in K2_TMA_CASES if k == 'tma'])
def test_fused_tail_tma_agrees_with_the_mma_sync_kernel(cuda, case):
    """Where the TMA kernel takes a shape, the mma.sync kernel it replaced
    (through the private ``_prepare``) computes the same products in the
    same order per pixel: the two outputs are equal."""
    args = _k2_inputs(case, torch.bfloat16, cuda)
    with torch.no_grad():
        layout = fb_cuda.TailLayout(*args[2:])
        new = fb_cuda.launch_tail(fb_cuda._prepare(args[0], args[1], layout))
        old = fb_cuda.launch_tail(fb_cuda._prepare(args[0], args[1], layout,
                                                   'mma_sync'))
        torch.cuda.synchronize()
    assert torch.equal(new, old)
    with pytest.raises(ValueError, match='does not take'):
        fb_cuda._prepare(args[0], args[1], layout, 'cuda_cores')


@pytest.mark.gpu
def test_fused_tail_tma_refuses_misaligned_tensors(cuda):
    case = (1, 8, 8, 8, 16, 16, 16, False)
    y1, x, *weights = _k2_inputs(case, torch.bfloat16, cuda)
    flat = torch.zeros(y1.numel() + 1, device=cuda, dtype=torch.bfloat16)
    odd = flat[1:].view(y1.shape).copy_(y1)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with torch.no_grad(), pytest.raises(ValueError, match='16-byte aligned'):
        fb_cuda.fused_bottleneck_tail_cuda(odd, x, *weights)


@pytest.mark.gpu
def test_slowfast_block_cache_on_the_card(cuda):
    """A fused block keeps its laid-out weights between forwards, and a BN
    buffer changed in place reaches the kernel's output."""
    from pretorched_tpu_torch.models.slowfast import Bottleneck

    blk = Bottleneck(32, 8, 1, False, 3).to(cuda).eval().bfloat16()
    blk.fuse = True
    x = torch.randn(2, 32, 4, 16, 16, device=cuda).bfloat16()
    with torch.no_grad():
        first = blk(x)
        layout = blk.tail_layout()
        assert blk(x).equal(first) and blk.tail_layout() is layout
        blk.bn3.running_mean.add_(1.0)
        changed = blk(x)
        y1 = torch.relu(blk.bn1(blk.conv1(x)))
        want = fb.fused_bottleneck_tail_reference(y1, x, *blk.tail_weights())
    assert blk.tail_layout() is not layout
    assert _rel_to_max(changed, want) <= 2e-2


@pytest.mark.gpu
def test_fused_tail_kernel_refuses_what_it_does_not_take(cuda):
    args = list(_k2_inputs((1, 2, 5, 5, 32, 8, 32, False), torch.float32,
                           cuda))
    with pytest.raises(ValueError, match='x_res is torch.bfloat16'):
        fb_cuda.fused_bottleneck_tail_cuda(args[0], args[1].bfloat16(),
                                           *args[2:])
    args[2].requires_grad_()
    with pytest.raises(ValueError, match='eval-only'):
        fb_cuda.fused_bottleneck_tail_cuda(*args)


@pytest.mark.gpu
def test_slowfast_fused_blocks_on_the_card(cuda):
    """A small SlowFast in f32 with fused_blocks=32 launches K2 once per
    fused block and gives the logits of fused_blocks=0."""
    from pretorched_tpu_torch.models.slowfast import SlowFast

    model = SlowFast(layers=(2, 2, 3, 1), num_classes=7,
                     fused_blocks=32).to(cuda).eval()
    x = torch.randn(2, 3, 32, 64, 64, device=cuda)
    before = fb_cuda.fused_bottleneck_tail_cuda.launches
    with torch.no_grad():
        fused = model(x)
        assert fb_cuda.fused_bottleneck_tail_cuda.launches == before + 5
        model.fused_blocks = 0
        plain = model(x)
    assert ((fused - plain).norm() / plain.norm()).item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize('b', [1, 2, 4])
@pytest.mark.parametrize('n,c', [(6272, 256), (784, 512)])
def test_served_bucket_shapes_match_plain(cuda, b, n, c):
    """K1-fwd at the video server's small buckets, both non-local layers of
    nonlocalresnet3d50 at 32 frames x 224 px (at B = 1 layer 2's wgmma grid
    is 98 query blocks, fewer than the card's SMs), bf16 against the plain
    version in f32, at phase 3's tolerances."""
    q, k, v, _ = _bwd_inputs(b, n, n, c, c, torch.bfloat16, cuda)
    program = na._program(na.attention_kernel(torch.bfloat16, c, c, 'fwd'),
                          c, c)
    before = na.nonlocal_attention_cuda.by_kernel[program]
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_cuda.by_kernel[program] == before + 1
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)
    assert _rel_err(out, want) <= 2e-2
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-2)


# K1-fwd at the native-length eval's buckets (video_eval_torch.py --frames
# native, --frame-multiple 8): a bucket of T frames runs layer 2 at
# N = Nk = T/4 * 784, C = Cv = 256 and layer 3 at T/8 * 196, C = Cv = 512,
# for one video's 10 clips (B = 10); most N are no multiple of 64, and
# layer 3's at T = 24 (588) is under ten query blocks
NATIVE_FRAMES = (24, 32, 40, 56, 64)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,tol_out,tol_lse', [
    (torch.float32, 2e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize('layer', [2, 3])
@pytest.mark.parametrize('frames', NATIVE_FRAMES)
def test_native_length_shapes_match_plain(cuda, frames, layer, dtype,
                                          tol_out, tol_lse):
    """The program the dispatch picks (bf16: wgmma at layer 2, the wide
    wgmma program at layer 3; f32: tf32x3) against the plain version in
    f32 on the same inputs, at phase 3's tolerances (bf16 out also within
    2e-2 of the largest |out|)."""
    n, c = ((frames // 4 * 784, 256) if layer == 2
            else (frames // 8 * 196, 512))
    q, k, v, _ = _bwd_inputs(10, n, n, c, c, dtype, cuda)
    program = na._program(na.attention_kernel(dtype, c, c, 'fwd'), c, c)
    assert program == ('tf32_wgmma' if dtype == torch.float32 else
                       'wgmma' if layer == 2 else 'wgmma_wide')
    before = na.nonlocal_attention_cuda.by_kernel[program]
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_cuda.by_kernel[program] == before + 1
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, rtol=0, atol=tol_out)
    if dtype == torch.bfloat16:
        assert _rel_err(out, want) <= 2e-2
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=tol_lse)


@pytest.mark.gpu
def test_served_resnet18_rows_match_the_direct_forward(cuda):
    """``serve_model`` on the card (pinned staging, events, resolver): each
    row equals the model's direct forward of that example (f32, TF32 off),
    for single requests padded to a bucket and for a batch."""
    import pretorched_tpu_torch
    from pretorched_tpu_torch.serving import serve_model

    model = pretorched_tpu_torch.resnet18(num_classes=10, pretrained=None)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    x = np.random.RandomState(0).randn(7, 3, 64, 64).astype(np.float32)
    with serve_model(model, max_batch=8, max_wait_ms=5.0) as srv:
        assert srv.device.type == 'cuda'
        singles = [srv.submit(xi) for xi in x[:3]]
        batch = srv.submit(x[3:])
        got = torch.stack([f.result(timeout=120) for f in singles]
                          + list(batch.result(timeout=120)))
    assert got.device.type == 'cpu'
    with torch.inference_mode():
        want = model(torch.from_numpy(x).to(cuda)).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,kernel,tol_out,tol_lse', [
    (torch.float32, 'tf32_wgmma', 2e-4, 1e-4),
    (torch.bfloat16, 'wgmma', 2e-2, 1e-2)],
    ids=['dtype0-tf32x3-0.0002-0.0001', 'dtype1-wgmma-0.02-0.01'])
@pytest.mark.parametrize('b,n,c', [(64, 196, 16), (64, 49, 32)])
def test_mnist_nonlocal_shapes_match_plain(cuda, dtype, kernel, tol_out,
                                           tol_lse, b, n, c):
    """K1-fwd at ``MNISTNonLocalNet``'s two attention shapes (64 images:
    N = 196, C = 16 and N = 49, C = 32), on the kernel the dispatch picks
    (C is a multiple of 8, so bf16 takes the wgmma program on widths padded
    to 64; f32 tf32_wgmma, whose pre-pass pads them to 32), against the
    plain version at phase 3's tolerances."""
    q, k, v, _ = _bwd_inputs(b, n, n, c, c, dtype, cuda)
    assert na.attention_kernel(dtype, c, c, 'fwd') == kernel
    before = na.nonlocal_attention_cuda.by_kernel[kernel]
    out, lse = na.nonlocal_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert na.nonlocal_attention_cuda.by_kernel[kernel] == before + 1
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, rtol=0, atol=tol_out)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=tol_lse)


@pytest.mark.gpu
def test_mnist_nonlocal_net_launches_k1_twice(cuda):
    """The tutorial net on the card: two K1-fwd launches a forward, and
    the logits of the plain attention (f32, TF32 off)."""
    from pretorched_tpu_torch.models import nonlocalnet

    model = nonlocalnet.MNISTNonLocalNet().to(cuda).eval()
    for block in (model.nonlocal1, model.nonlocal2):
        torch.nn.init.uniform_(block.W[1].weight, 0.5, 1.5)
    x = torch.randn(8, 1, 28, 28, device=cuda)
    before = na.nonlocal_attention_cuda.launches
    with torch.no_grad():
        got = model(x)
        assert na.nonlocal_attention_cuda.launches == before + 2
        orig = nonlocalnet.auto_nonlocal_attention
        nonlocalnet.auto_nonlocal_attention = na.nonlocal_attention_reference
        try:
            want = model(x)
        finally:
            nonlocalnet.auto_nonlocal_attention = orig
    assert ((got - want).norm() / want.norm()).item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize('kernel,ndim,fold,shape', [
    (7, 3, 2, (2, 3, 16, 112, 112)),
    ((5, 7, 7), 3, 4, (2, 3, 32, 224, 224)),
    ((1, 7, 7), 3, 2, (2, 3, 4, 224, 224)),
    (7, 2, 2, (4, 3, 224, 224)),
    (7, 3, 2, (1, 3, 8, 57, 59)),
])
def test_space_to_depth_conv_matches_strided_conv_on_the_card(
        cuda, kernel, ndim, fold, shape):
    """The folded stem on the card (cuDNN on the folded conv) against the
    plain strided conv on the same weight, f32 with TF32 off, 1e-4; the
    last case takes the plain conv (odd sizes)."""
    from pretorched_tpu_torch.models.layers import (SpaceToDepthConv,
                                                    init_parameters)
    import torch.nn.functional as F

    mod = SpaceToDepthConv(3, 64 if fold == 2 else 8, kernel, ndim=ndim,
                           fold=fold)
    init_parameters(mod, torch.Generator().manual_seed(0))
    mod.to(cuda)
    x = torch.randn(*shape, device=cuda)
    ks = mod.kernel_size
    with torch.no_grad():
        got = mod(x)
        if ndim == 3:
            want = F.conv3d(x, mod.weight, stride=(1, 2, 2),
                            padding=tuple(k // 2 for k in ks))
        else:
            want = F.conv2d(x, mod.weight, stride=2, padding=ks[-1] // 2)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# the rest of the 2D zoo: no kernel of the port, cuDNN and PyTorch ops only
IMAGE_ZOO = ('inceptionv3', 'inceptionv4', 'inceptionresnetv2',
             'bninception', 'xception', 'dpn68', 'dpn68b', 'dpn92', 'dpn98',
             'dpn107', 'dpn131', 'mobilenetv2', 'pnasnet5large', 'polynet',
             'vggm', 'wideresnet50')


@pytest.mark.gpu
@pytest.mark.parametrize('name', IMAGE_ZOO)
def test_image_zoo_bf16_forward_on_the_card(cuda, name):
    """Each factory built on the card (seeded, every BN randomized): a bf16
    forward of 2 images at its own ``input_size``, finite, within 5e-2 (rel
    L2) of the f32 forward (TF32 off), and no K1 or K2 launch."""
    import pretorched_tpu_torch

    model = pretorched_tpu_torch.__dict__[name](num_classes=1000,
                                                pretrained=None)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    model.to(cuda).eval()
    x = torch.randn(2, *model.input_size, generator=g).to(cuda)
    launches = (na.nonlocal_attention_cuda.launches,
                fb_cuda.fused_bottleneck_tail_cuda.launches)
    with torch.no_grad():
        want = model(x)
        got = model.bfloat16()(x).float()
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and bool(torch.isfinite(got).all())
    assert ((got - want).norm() / want.norm()).item() <= 5e-2
    assert (na.nonlocal_attention_cuda.launches,
            fb_cuda.fused_bottleneck_tail_cuda.launches) == launches


@pytest.mark.gpu
def test_attention_operator_launches_the_kernel(cuda):
    """``pretorched::nonlocal_attention_fwd`` on CUDA tensors is K1-fwd:
    one launch, on the program the dispatch picks."""
    q, k, v, _ = _bwd_inputs(2, 300, 300, 64, 64, torch.bfloat16, cuda)
    before = dict(na.nonlocal_attention_cuda.by_kernel)
    out, lse = torch.ops.pretorched.nonlocal_attention_fwd(q, k, v, 1.0)
    torch.cuda.synchronize()
    after = na.nonlocal_attention_cuda.by_kernel
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == 'wgmma') for p in na.PROGRAMS}
    want, want_lse = na.nonlocal_attention_fwd_lse_reference(
        q.float(), k.float(), v.float())
    assert _rel_to_max(out, want) <= 2e-2
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-2)


@pytest.mark.gpu
def test_tail_operator_launches_the_kernel(cuda):
    args = _k2_inputs(K2_CASES[0], torch.bfloat16, cuda)
    before = fb_cuda.fused_bottleneck_tail_cuda.launches
    with torch.no_grad():
        out = torch.ops.pretorched.fused_bottleneck_tail(*args)
        torch.cuda.synchronize()
        assert fb_cuda.fused_bottleneck_tail_cuda.launches == before + 1
        want = fb.fused_bottleneck_tail_reference(*args)
    assert _rel_err(out, want.float()) <= 2e-2


@pytest.mark.gpu
def test_export_on_the_card_records_the_operators(cuda, tmp_path):
    """Exported on the card, a bf16 non-local net and a fused SlowFast hold
    the operators and no plain attention; the reloaded programs launch the
    kernels (2 K1-fwd, 3 K2 a forward) and match the eager forward."""
    import pretorched_tpu_torch
    from pretorched_tpu_torch.models import slowfast
    from pretorched_tpu_torch.zoo.export import (export_model,
                                                 exported_program_text,
                                                 load_exported)

    torch.manual_seed(0)
    nl = pretorched_tpu_torch.nonlocalresnet3d18(num_classes=5,
                                                 pretrained=None)
    sf = slowfast.SlowFast(layers=(1, 2, 2, 1), num_classes=5,
                           fused_blocks=32)
    cases = ((nl.bfloat16(), (3, 8, 64, 64), na.nonlocal_attention_cuda,
              'pretorched.nonlocal_attention_fwd', 2),
             (sf, (3, 16, 64, 64), fb_cuda.fused_bottleneck_tail_cuda,
              'pretorched.fused_bottleneck_tail', 3))
    for model, shape, wrapper, op, per_forward in cases:
        model.to(cuda).eval()
        txt = exported_program_text(model, shape, batch='2')
        assert txt.count(op) == per_forward and 'logsumexp' not in txt
        path = str(tmp_path / 'program.pt2')
        export_model(model, path, shape, batch='2')
        call, params = load_exported(path)
        x = torch.randn(2, *shape, device=cuda)
        before = wrapper.launches
        got = call(params, x)
        torch.cuda.synchronize()
        assert wrapper.launches == before + per_forward
        with torch.no_grad():
            want = model(x)
        assert ((got.float() - want.float()).norm()
                / want.float().norm()).item() <= 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_pipelined_nonlocal_forward_launches_k1_per_microbatch(cuda, dtype):
    """``nonlocalresnet3d50`` pipelined over its four stages on the card
    (``devices=['cuda:0'] * 4``, 4 microbatches of 2 clips x 8 frames x 112
    px, every BN randomized): 20 K1-fwd launches, 5 a microbatch (bf16: 2
    wgmma + 3 wgmma_wide), and the logits of the unpipelined forward (rel
    L2: bf16 5e-2 as ``chip_smoke.py``'s phase 21, f32 with TF32 off
    1e-4)."""
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.models.resnet3d import (pipeline_stage_fns,
                                                      split_stage_variables)
    from pretorched_tpu_torch.parallel.pipeline import pipeline_apply_stages

    torch.manual_seed(0)
    model = pretorched.nonlocalresnet3d50(num_classes=400, pretrained=None)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    model.to(cuda).eval()
    if dtype == 'bfloat16':
        model.bfloat16()
    x = torch.randn(8, 3, 8, 112, 112, device=cuda)
    fwd = na.nonlocal_attention_cuda
    before = dict(fwd.by_kernel), fwd.launches
    with torch.inference_mode():
        got = pipeline_apply_stages(
            pipeline_stage_fns(model),
            split_stage_variables(model.state_dict()), x,
            devices=['cuda:0'] * 4, n_micro=4).float()
        assert fwd.launches == before[1] + 20
        if dtype == 'bfloat16':
            assert fwd.by_kernel['wgmma'] == before[0]['wgmma'] + 8
            assert fwd.by_kernel['wgmma_wide'] == before[0]['wgmma_wide'] + 12
        want = model(x).float()
    rel = ((got - want).norm() / want.norm()).item()
    assert torch.isfinite(got).all() and rel <= (
        5e-2 if dtype == 'bfloat16' else 1e-4), rel


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_seq_stacked_nonlocal_step_on_the_card(cuda, dtype):
    """``nonlocalresnet3d50`` time-sharded over 2 shards stacked in one
    process (``parallel.seq.seq_parallel(model, shards=2)``; 2 clips x 16
    frames x 112 px, every BN randomized, eval mode: in train mode the
    bf16 logits of these random weights move chaotically between any two
    batch layouts): a forward and backward launch each K1 kernel 5 times
    (bf16: 2 wgmma + 3 wgmma_wide), every query shard against the keys of
    both (N != Nk), and the logits equal the unsharded forward's (rel L2:
    bf16 5e-2 as ``chip_smoke.py``'s phase 21, f32 with TF32 off 1e-4)."""
    import copy

    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.parallel.seq import seq_parallel

    torch.manual_seed(0)
    model = pretorched.nonlocalresnet3d50(num_classes=400, pretrained=None)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    model.to(cuda).eval()
    if dtype == 'bfloat16':
        model.bfloat16()
    sharded = seq_parallel(copy.deepcopy(model), shards=2)
    x = torch.randn(2, 3, 16, 112, 112, device=cuda)
    wrappers = (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
                na.nonlocal_attention_bwd_dkv_cuda)
    before = [(w.launches, dict(w.by_kernel)) for w in wrappers]
    got = sharded(x)
    got.float().square().mean().backward()
    torch.cuda.synchronize()
    for w, (n, by) in zip(wrappers, before):
        assert w.launches == n + 5
        if dtype == 'bfloat16':
            assert w.by_kernel['wgmma'] == by['wgmma'] + 2
            assert w.by_kernel['wgmma_wide'] == by['wgmma_wide'] + 3
    with torch.no_grad():
        want = model(x)
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert torch.isfinite(got).all() and rel <= (
        5e-2 if dtype == 'bfloat16' else 1e-4), rel
