"""The port's fused bottleneck tail against the JAX package's.

On the CPU the dispatcher takes the plain version, compared here with the
Pallas kernel (``fused_bottleneck_tail(..., interpret=True)``) on the same
numpy inputs: f32 at 1e-4 (sums in another order), bf16 at 2e-2 (both round
y2 and the output to bf16, so a sum that lands near a rounding boundary can
differ by one bf16 step). The kernel itself runs only on a CUDA card
(``tests/test_torch_kernels_gpu.py`` holds it against the plain version);
here its weight layouts are checked by redoing its arithmetic in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretorched_tpu.ops.pallas import fused_block as jax_fb
from pretorched_tpu_torch.models.layers import batch_norm
from pretorched_tpu_torch.ops import fused_block as fb
from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _tail_args(cin, cm, cout, proj, b=2, t=4, h=14, w=14, seed=0):
    """Numpy inputs in the JAX layouts (as tests/test_fused_block.py)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(y1=(rng.randn(b, t, h, w, cm) * 0.5).astype(f),
                x_res=(rng.randn(b, t, h, w, cin) * 0.5).astype(f),
                w2=(rng.randn(3, 3, cm, cm) * 0.2).astype(f),
                a2=rng.randn(2, cm).astype(f),
                w3=(rng.randn(cm, cout) * 0.2).astype(f),
                a3=rng.randn(2, cout).astype(f),
                wp=(rng.randn(cin, cout) * 0.2).astype(f) if proj else None,
                ap=rng.randn(2, cout).astype(f) if proj else None)


def _to_port(a, dtype):
    """JAX layouts -> the port's: (B, T, H, W, C) -> (B, C, T, H, W), HWIO
    -> OIHW, (in, out) -> (out, in)."""
    t = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x))
    return dict(y1=t(np.moveaxis(a['y1'], -1, 1)).to(dtype),
                x_res=t(np.moveaxis(a['x_res'], -1, 1)).to(dtype),
                w2=t(np.transpose(a['w2'], (3, 2, 0, 1))), a2=t(a['a2']),
                w3=t(a['w3'].T), a3=t(a['a3']),
                wp=None if a['wp'] is None else t(a['wp'].T), ap=t(a['ap']))


def _jax_tail(a, dtype):
    args = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    args['y1'] = args['y1'].astype(dtype)
    args['x_res'] = args['x_res'].astype(dtype)
    out = jax_fb.fused_bottleneck_tail(**args, interpret=True)
    return np.moveaxis(np.asarray(out, np.float32), -1, 1)


CASES = {   # name: (cin, cm, cout, proj, (b, t, h, w))
    'identity': (32, 8, 32, False, (2, 4, 14, 14)),
    'projection': (8, 8, 32, True, (2, 4, 14, 14)),
    'odd': (64, 16, 64, False, (1, 3, 7, 7)),
}


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_tail_matches_pallas(case, dtype, tol):
    cin, cm, cout, proj, (b, t, h, w) = CASES[case]
    a = _tail_args(cin, cm, cout, proj, b, t, h, w)
    want = _jax_tail(a, jnp.float32 if dtype == torch.float32
                     else jnp.bfloat16)
    before = fb_cuda.fused_bottleneck_tail_cuda.launches
    with torch.no_grad():
        got = fb.fused_bottleneck_tail(**_to_port(a, dtype))
    assert fb_cuda.fused_bottleneck_tail_cuda.launches == before  # CPU: plain
    assert got.dtype == dtype and got.shape == (b, cout, t, h, w)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_fold_bn_matches_batchnorm_and_jax():
    rng = np.random.RandomState(1)
    c = 8
    bn = batch_norm(c).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(c) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.randn(c)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(c)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(c) + 0.2))
    x = torch.from_numpy(rng.randn(4, c, 2, 3, 5).astype(np.float32))
    s, b = fb.fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                      bn.eps)
    with torch.no_grad():
        torch.testing.assert_close(x * s[:, None, None, None]
                                   + b[:, None, None, None], bn(x),
                                   rtol=1e-5, atol=1e-5)
    js, jb = jax_fb.fold_bn(*(jnp.asarray(p.detach().numpy()) for p in (
        bn.weight, bn.bias, bn.running_mean, bn.running_var)), bn.eps)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def _mma_padded(c):
    return -(-c // 16) * 16 + 8


@pytest.mark.parametrize('layout', ['cuda_cores', 'tensor_cores'])
@pytest.mark.parametrize('case', ['projection', 'odd'])
def test_kernel_weight_layout_reproduces_the_tail(case, layout):
    """The kernel's arithmetic, redone in numpy on the weights as each of
    its two paths reads them (``kernel_weights`` at chunk widths 16 and
    32; ``mma_weights`` with channel dims padded to 16 + 8), gives the
    plain version's output: a wrong permutation or padding fails."""
    cin, cm, cout, proj, (b, t, h, w) = CASES[case]
    p = _to_port(_tail_args(cin, cm, cout, proj, b, t, h, w, seed=2),
                 torch.float32)
    if layout == 'cuda_cores':    # (ci, tap, co_pad), (ci, co_pad)
        w2t, w3t, wpt = (None if x is None else x.numpy() for x in
                         fb_cuda.kernel_weights(p['w2'], p['w3'], p['wp'],
                                                torch.float32, 16, 32))
        assert w2t.shape == (cm, 9, 16)
        assert w3t.shape == (cm, -(-cout // 32) * 32)
    else:                         # (tap, co, ci_pad), (co, ci_pad)
        w2b, w3b, wpb = (None if x is None else x.float().numpy() for x in
                         fb_cuda.mma_weights(p['w2'], p['w3'], p['wp'],
                                             _mma_padded))
        assert w2b.shape == (9, cm, _mma_padded(cm))
        w2t = np.transpose(w2b, (2, 0, 1))
        w3t, wpt = w3b.T, None if wpb is None else wpb.T
    y1 = np.pad(p['y1'].numpy(), ((0, 0), (0, 0), (0, 0), (1, 1), (1, 1)))
    a2, a3 = p['a2'].numpy(), p['a3'].numpy()
    y2 = np.zeros((b, w2t.shape[2], t, h, w), np.float32)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        y2 += np.einsum('io,bithw->bothw', w2t[:y1.shape[1], tap],
                        y1[:, :, :, dy:dy + h, dx:dx + w])
    y2 = np.maximum(y2[:, :cm] * a2[0][:, None, None, None]
                    + a2[1][:, None, None, None], 0)
    y3 = np.einsum('co,bcthw->bothw', w3t[:cm], y2)[:, :cout]
    x = p['x_res'].numpy()
    if proj:
        ap = p['ap'].numpy()
        res = np.einsum('co,bcthw->bothw', wpt[:cin], x)[:, :cout]
        res = res * ap[0][:, None, None, None] + ap[1][:, None, None, None]
    else:
        res = x
    out = np.maximum(y3 * a3[0][:, None, None, None]
                     + a3[1][:, None, None, None] + res, 0)
    if layout == 'tensor_cores':  # the weights the bf16 path rounds
        p.update({k: p[k].bfloat16().float() for k in ('w2', 'w3', 'wp')
                  if p[k] is not None})
    with torch.no_grad():
        want = fb.fused_bottleneck_tail_reference(**p).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_tail_is_eval_only_on_the_cpu():
    p = _to_port(_tail_args(8, 8, 32, True, 1, 2, 5, 5), torch.float32)
    p['w3'].requires_grad_()
    with pytest.raises(ValueError, match='eval-only'):
        fb.fused_bottleneck_tail(**p)
    with torch.no_grad():
        fb.fused_bottleneck_tail(**p)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """CPU tensors, mixed dtypes of y1 and x_res, and inputs that need a
    gradient are refused before any build is attempted."""
    p = _to_port(_tail_args(32, 8, 32, False, 1, 2, 5, 5), torch.float32)
    with pytest.raises(ValueError, match='CUDA'):
        fb_cuda.fused_bottleneck_tail_cuda(**p)
    mixed = dict(p, x_res=p['x_res'].bfloat16())
    with pytest.raises(ValueError, match='x_res is torch.bfloat16'):
        fb_cuda.fused_bottleneck_tail_cuda(**mixed)
    with pytest.raises(ValueError, match='x_res is torch.bfloat16'):
        fb.fused_bottleneck_tail(**mixed)
    grad = dict(p, y1=p['y1'].clone().requires_grad_())
    with pytest.raises(ValueError, match='eval-only'):
        fb_cuda.fused_bottleneck_tail_cuda(**grad)
    with pytest.raises(ValueError, match='Cin == Cout'):
        fb_cuda.fused_bottleneck_tail_cuda(**dict(p, w3=p['w3'][:16],
                                                  a3=p['a3'][:, :16]))
