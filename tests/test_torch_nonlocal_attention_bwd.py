"""The port's non-local attention backward against the JAX package's.

On the CPU the backward takes its plain version, compared here with the
Pallas backward (``_nonlocal_attention_bwd_blockwise``, ``interpret=True``)
on the same out and lse, and the autograd Function with ``jax.grad`` of the
custom VJP. Both sides compute in f32 with sums in another order: 1e-4. The
kernels themselves run only on a CUDA card
(``tests/test_torch_kernels_gpu.py`` holds them against the plain version).

JAX dispatches asynchronously, so each JAX result is brought to numpy (which
waits for it) before the port's side runs: the port's CPU kernels then never
share the cores with XLA's threads still at work on the same process's
computation.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretorched_tpu.ops.pallas.nonlocal_attention import (
    _nonlocal_attention_ad, _nonlocal_attention_bwd_blockwise,
    _nonlocal_attention_fwd_lse)
from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

from test_torch_nonlocal_attention import (CASES, DISPATCH, DISPATCH_IDS,
                                           _inputs, kernels_by_op)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _launches():
    return (na.nonlocal_attention_cuda.launches,
            na.nonlocal_attention_bwd_dq_cuda.launches,
            na.nonlocal_attention_bwd_dkv_cuda.launches)


@pytest.mark.parametrize('b,n,nk,c,cv,scale', CASES)
def test_plain_backward_matches_pallas(b, n, nk, c, cv, scale):
    q, k, v = _inputs(b, n, nk, c, cv)
    do = np.random.RandomState(1).randn(b, n, cv).astype(np.float32)
    o, lse = _nonlocal_attention_fwd_lse(q, k, v, scale=scale, interpret=True)
    want = [np.asarray(w) for w in _nonlocal_attention_bwd_blockwise(
        q, k, v, o, lse, do, scale=scale, interpret=True)]
    got = na.nonlocal_attention_bwd_reference(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        scale)
    for g, w, name in zip(got, want, ('dq', 'dk', 'dv')):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize('b,n,nk,c,cv,scale', CASES)
def test_autograd_matches_jax_grad(b, n, nk, c, cv, scale):
    """``auto_nonlocal_attention`` with a gradient goes through
    ``NonLocalAttention``; on CPU tensors it launches no kernel."""
    q, k, v = _inputs(b, n, nk, c, cv)
    ct = np.random.RandomState(2).randn(b, n, cv).astype(np.float32)

    def loss(q, k, v):
        return (jnp.asarray(ct) * _nonlocal_attention_ad(q, k, v, scale,
                                                         True)).sum()

    want = [np.asarray(w) for w in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = _launches()
    out = na.auto_nonlocal_attention(tq, tk, tv, scale)
    assert type(out.grad_fn).__name__ == 'NonLocalAttentionBackward'
    got = torch.autograd.grad((torch.from_numpy(ct) * out).sum(),
                              (tq, tk, tv))
    assert _launches() == before
    for g, w, name in zip(got, want, ('dq', 'dk', 'dv')):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_no_grad_takes_the_forward_alone():
    """Under ``no_grad`` / ``inference_mode`` nothing is saved for a
    backward (the eval path stays one forward per block)."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs(1, 64, 64, 8, 8))
    with torch.no_grad():
        assert na.auto_nonlocal_attention(tq, tk, tv).grad_fn is None
    with torch.inference_mode():
        assert na.auto_nonlocal_attention(tq, tk, tv).grad_fn is None


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 4, 8)
    lse = torch.zeros(1, 4)
    with pytest.raises(ValueError, match='CUDA'):
        na.nonlocal_attention_bwd_dq_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match='CUDA'):
        na.nonlocal_attention_bwd_dkv_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match='CUDA'):
        na.nonlocal_attention_bwd_cuda(q, q, q, q, lse, q)


def test_plain_backward_keeps_bf16_dtypes():
    """bf16 in, bf16 gradients out, computed in f32 inside."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(2, 40, 24, 8, 12))
    o, lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
    do = torch.ones_like(o)
    dq, dk, dv = na.nonlocal_attention_bwd_reference(q, k, v, o, lse, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.parametrize('dtype,c,cv,kernel', DISPATCH, ids=DISPATCH_IDS)
def test_dq_dispatch_routes_each_shape(monkeypatch, dtype, c, cv, kernel):
    """K1-dq takes the kernel ``attention_kernel`` picks for it: the wgmma
    entry (no dtype code) for bf16 with C and Cv multiples of 64 up to 256,
    its wide entry past 256 up to 512 (layer 3's 512), counted as
    ``wgmma_wide``; the tf32_wgmma entry (no dtype code, a scratch tensor
    after dq) for f32 up to 512; the generic entry with its dtype code
    otherwise. The C entry is replaced by a recorder, so no card is
    needed."""
    kernel = kernels_by_op(kernel)['dq']
    entries = []
    monkeypatch.setattr(na, '_launch',
                        lambda entry, *args: entries.append((entry, args[-1])))
    q = torch.zeros(1, 8, c, dtype=dtype)
    v = torch.zeros(1, 8, cv, dtype=dtype)
    stats = torch.zeros(1, 8)
    fn = na.nonlocal_attention_bwd_dq_cuda
    before = dict(fn.by_kernel)
    dq = na._launch_dq(q, q, v, v, stats, stats, 1.0,
                       na.attention_kernel(dtype, c, cv, 'dq'))
    assert dq.shape == q.shape and dq.dtype == dtype
    program = ('wgmma_wide' if kernel == 'wgmma' and max(c, cv) > 256
               else kernel)
    if kernel in ('wgmma', 'tf32_wgmma'):
        assert entries == [(f'pt_nonlocal_attention_bwd_dq_{program}', 1.0)]
    else:
        assert entries == [('pt_nonlocal_attention_bwd_dq',
                            na._DTYPE_CODES[dtype])]
    assert {k: fn.by_kernel[k] - before[k] for k in na.PROGRAMS} == {
        k: int(k == program) for k in na.PROGRAMS}


def test_dq_private_launch_takes_mma_sync_and_refuses_the_rest(monkeypatch):
    """``_launch_dq`` runs the generic kernel at a wgmma shape, layer 3's
    512 included (the A/B against the kernel wgmma replaced), and refuses
    any other forced choice; the public wrapper takes no kernel keyword."""
    monkeypatch.setattr(na, '_launch', lambda *args: None)
    q = torch.zeros(1, 8, 256, dtype=torch.bfloat16)
    stats = torch.zeros(1, 8)
    na._launch_dq(q, q, q, q, stats, stats, 1.0, 'mma_sync')
    with pytest.raises(ValueError, match='does not take'):
        na._launch_dq(q, q, q, q, stats, stats, 1.0, 'scalar')
    wide = torch.zeros(1, 8, 512, dtype=torch.bfloat16)
    for kernel in ('wgmma', 'mma_sync'):
        na._launch_dq(wide, wide, wide, wide, stats, stats, 1.0, kernel)
    for c in (1024, 576):
        x = torch.zeros(1, 8, c, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match='does not take'):
            na._launch_dq(x, x, x, x, stats, stats, 1.0, 'wgmma')
    assert 'kernel' not in inspect.signature(
        na.nonlocal_attention_bwd_dq_cuda).parameters
