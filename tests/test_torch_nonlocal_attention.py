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
# faults: lse shaped per row for B > 1, and v/out sized by Cv, not C.
CASES = [
    (1, 256, 256, 32, 32, 1.0),
    (2, 300, 300, 32, 32, 1.0),
    (2, 300, 72, 32, 32, 0.5),
    (2, 300, 72, 16, 64, 1.0),
    (3, 200, 200, 16, 16, 0.25),
    (2, 130, 520, 8, 24, 2.0),
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


# (dtype, C, Cv, kernel): the layer-2 and sub_sample shapes (C = Cv = 256),
# Cv != C, the smallest wgmma shape; layer 3 (512), gaussian mode (1024)
# and channels that are no multiple of 64 stay on mma.sync; f32 is scalar
DISPATCH = [
    (torch.bfloat16, 256, 256, 'wgmma'),
    (torch.bfloat16, 64, 256, 'wgmma'),
    (torch.bfloat16, 256, 64, 'wgmma'),
    (torch.bfloat16, 64, 64, 'wgmma'),
    (torch.bfloat16, 128, 192, 'wgmma'),
    (torch.bfloat16, 512, 512, 'mma_sync'),
    (torch.bfloat16, 1024, 512, 'mma_sync'),
    (torch.bfloat16, 256, 320, 'mma_sync'),
    (torch.bfloat16, 32, 32, 'mma_sync'),
    (torch.bfloat16, 96, 64, 'mma_sync'),
    (torch.float32, 256, 256, 'scalar'),
    (torch.float32, 32, 24, 'scalar'),
]


@pytest.mark.parametrize('dtype,c,cv,kernel', DISPATCH)
def test_dispatch_picks_kernel_by_dtype_and_shape(dtype, c, cv, kernel):
    assert na.attention_kernel(dtype, c, cv) == kernel
    na._check_kernel(dtype, c, cv, kernel)


def test_dispatch_takes_mma_sync_by_name_and_refuses_the_rest():
    """The private launch routes may send a wgmma shape to the mma.sync
    kernels (the A/B against the kernel wgmma replaced); nothing else is
    forced, and the public wrappers take no kernel choice."""
    na._check_kernel(torch.bfloat16, 256, 256, 'mma_sync')
    with pytest.raises(ValueError, match='does not take'):
        na._check_kernel(torch.bfloat16, 512, 512, 'wgmma')
    with pytest.raises(ValueError, match='does not take'):
        na._check_kernel(torch.float32, 256, 256, 'wgmma')
    with pytest.raises(ValueError, match='does not take'):
        na._check_kernel(torch.float32, 256, 256, 'mma_sync')
    with pytest.raises(ValueError, match='not supported'):
        na.attention_kernel(torch.float16, 256, 256)
    for fn in (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dkv_cuda):
        assert 'kernel' not in inspect.signature(fn).parameters


def test_launch_counters_are_kept_per_kernel():
    for fn in (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dkv_cuda):
        assert set(fn.by_kernel) == set(na.KERNELS)
