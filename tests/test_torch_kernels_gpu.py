"""The port's CUDA kernels against their plain PyTorch versions, on a card.

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
# gaussian mode's wide C with a wide Cv, and Cv not a multiple of 8
CASES = [
    (1, 256, 256, 32, 32, 1.0),
    (2, 300, 300, 32, 32, 1.0),
    (2, 300, 72, 32, 32, 0.5),
    (2, 300, 72, 16, 64, 1.0),
    (3, 200, 200, 16, 16, 0.25),
    (2, 130, 520, 8, 24, 2.0),
    (2, 1000, 125, 1024, 512, 1.0),
    (2, 100, 90, 20, 150, 1.0),
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


@pytest.mark.gpu
def test_attention_kernel_refuses_gradients(cuda):
    q = torch.randn(1, 64, 16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        na.nonlocal_attention_cuda(q, q, q)
