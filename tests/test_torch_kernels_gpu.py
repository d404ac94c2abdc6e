"""The port's CUDA kernels (the non-local attention forward K1-fwd and its
backward K1-dq, K1-dkv) against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without CUDA. The file imports
no JAX, so it runs on a machine that has only PyTorch (the suite's
conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

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
]


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
    gradient. f32: scalar FMAs, sums in another order. bf16: ds and p are
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
