"""The port's BigGAN generator (``pretorched_tpu_torch/gan/biggan.py``)
against the JAX package's, on the CPU.

Each piece on carried weights with every BN's running statistics drawn at
random (and the output BN's scale and shift): ``CondBatchNorm``, an
up-sampling and a same-width ``GBlock``, ``SelfAttention`` (the JAX one
takes its einsum reference on the CPU, the port its plain attention), each
at 2e-4. The whole ``BigGAN(256, ch=16, 10 classes)`` built as the golden
lock of ``tests/test_golden_configs.py`` builds it (``jax.jit(init)`` with
key 0, ``gamma`` 0.5, z from key 1, labels [0, 7]): against the JAX
``apply`` at 2e-3 and against ``tests/golden/biggan256_sample.npz`` at the
lock's own tolerances; with random BN statistics against JAX again at 2e-3.
``gamma`` is carried by ``state_dict_from_flax`` and zeroing it moves the
image. A small 128 px model, the latent layout and its error, the skip
conv rule, and ``sample``'s draw.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretorched_tpu.gan import biggan as jbiggan
from pretorched_tpu_torch.gan import biggan
from pretorched_tpu_torch.zoo.convert import state_dict_from_flax

from torch_port_helpers import port_state_dict, to_numpy_tree
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_stats(variables, seed):
    """Numpy copy of ``variables`` with every running mean and variance
    drawn at random, and the scale and shift of each BN that has them."""
    out = to_numpy_tree(variables)
    rng = np.random.RandomState(seed)

    def walk(stats, params):
        for name, node in stats.items():
            if 'mean' in node:
                node['mean'] = rng.uniform(-0.3, 0.3, node['mean'].shape
                                           ).astype(np.float32)
                node['var'] = rng.uniform(0.5, 1.5, node['var'].shape
                                          ).astype(np.float32)
                p = (params or {}).get(name, {})
                if 'scale' in p:
                    p['scale'] = rng.uniform(0.5, 1.5, p['scale'].shape
                                             ).astype(np.float32)
                    p['bias'] = rng.uniform(-0.2, 0.2, p['bias'].shape
                                            ).astype(np.float32)
            else:
                walk(node, (params or {}).get(name))

    walk(out['batch_stats'], out['params'])
    return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _carry(model, variables):
    model.load_state_dict(port_state_dict(variables), strict=True)
    return model.eval()


def test_cond_batch_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 5, 12).astype(np.float32)
    cond = rng.randn(2, 9).astype(np.float32)
    jmod = jbiggan.CondBatchNorm(12)
    variables = _random_stats(jax.jit(jmod.init)(jax.random.key(0), x, cond),
                              1)
    want = np.asarray(jax.jit(jmod.apply)(variables, x, cond))
    model = _carry(biggan.CondBatchNorm(12, 9), variables)
    with torch.no_grad():
        got = model(_nchw(x), torch.from_numpy(cond)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('in_ch,out_ch,upsample', [(16, 8, True),
                                                   (8, 8, False)])
def test_gblock_matches_jax(in_ch, out_ch, upsample):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 6, in_ch).astype(np.float32)
    cond = rng.randn(2, 10).astype(np.float32)
    jmod = jbiggan.GBlock(out_ch, upsample=upsample)
    variables = _random_stats(jax.jit(jmod.init)(jax.random.key(0), x, cond),
                              2)
    want = np.asarray(jax.jit(jmod.apply)(variables, x, cond))
    model = _carry(biggan.GBlock(in_ch, out_ch, 10, upsample=upsample),
                   variables)
    assert (model.conv_sc is None) == (not upsample and in_ch == out_ch)
    with torch.no_grad():
        got = model(_nchw(x), torch.from_numpy(cond)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_self_attention_matches_jax():
    """(B, N, Nk, C, Cv) = (2, 64, 16, 4, 16): keys pooled 2x2, Cv = 4 C,
    ``gamma`` 0.5."""
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    jmod = jbiggan.SelfAttention()
    variables = flax.core.unfreeze(jmod.init(jax.random.key(0), x))
    variables['params']['gamma'] = jnp.asarray(0.5)
    want = np.asarray(jmod.apply(variables, x))
    model = _carry(biggan.SelfAttention(32), to_numpy_tree(variables))
    assert float(model.gamma.detach()) == 0.5
    with torch.no_grad():
        got = model(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert np.abs(want - x).max() > 1e-2      # the attention is in it


def test_biggan256_matches_jax_and_golden():
    module = jbiggan.BigGAN(resolution=256, ch=16, num_classes=10)
    z0 = jnp.zeros((1, module.latent_dim))
    y0 = jnp.zeros((1,), jnp.int32)
    variables = flax.core.unfreeze(
        jax.jit(module.init)(jax.random.key(0), z0, y0))
    variables['params']['attention']['gamma'] = jnp.asarray(0.5)
    z = jax.random.normal(jax.random.key(1), (2, module.latent_dim))
    y = jnp.asarray([0, 7], jnp.int32)
    apply = jax.jit(module.apply)
    want = np.asarray(apply(variables, z, y))

    sd = state_dict_from_flax(to_numpy_tree(variables))
    assert sd['attention.gamma'].shape == () and sd['attention.gamma'] == 0.5
    model = biggan.BigGAN(resolution=256, ch=16, num_classes=10)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    model.eval()
    zt = torch.from_numpy(np.array(z))
    yt = torch.from_numpy(np.array(y)).long()
    with torch.no_grad():
        img = model(zt, yt).permute(0, 2, 3, 1).numpy()
    assert img.shape == (2, 256, 256, 3)
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)
    golden = np.load(os.path.join(REPO, 'tests', 'golden',
                                  'biggan256_sample.npz'))
    np.testing.assert_allclose(img[:, ::16, ::16, :], golden['slice'],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img.mean(), golden['mean'], atol=1e-6)
    np.testing.assert_allclose(img.std(), golden['std'], atol=1e-6)

    # gamma 0 takes the attention out of the image
    with torch.no_grad():
        model.attention.gamma.zero_()
        off = model(zt, yt).permute(0, 2, 3, 1).numpy()
    assert np.abs(off - img).max() > 1e-3

    # every BN's running statistics at random: the same image as JAX's
    variables = _random_stats(variables, 3)
    want = np.asarray(apply(variables, z, y))
    model = _carry(model, variables)
    with torch.no_grad():
        img = model(zt, yt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)


def test_biggan128_small_matches_jax():
    """The 128 px arch at ch 8, attention at 16 px (``tests/test_biggan.py``)."""
    module = jbiggan.BigGAN(resolution=128, ch=8, num_classes=10, attn_res=16)
    z = np.random.RandomState(4).randn(2, module.latent_dim).astype(
        np.float32)
    y = np.asarray([1, 3], np.int32)
    variables = flax.core.unfreeze(
        jax.jit(module.init)(jax.random.key(0), z, y))
    variables['params']['attention']['gamma'] = jnp.asarray(0.5)
    variables = _random_stats(variables, 5)
    want = np.asarray(jax.jit(module.apply)(variables, z, y))
    model = _carry(biggan.BigGAN(128, 8, num_classes=10, attn_res=16),
                   variables)
    with torch.no_grad():
        got = model(torch.from_numpy(z), torch.from_numpy(y).long())
    assert got.shape == (2, 3, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-3, atol=2e-3)


def test_latent_layout_and_skip_rule():
    assert biggan.BigGAN(resolution=128, ch=2, num_classes=2).latent_dim == 120
    assert biggan.BigGAN(resolution=256, ch=2, num_classes=2).latent_dim == 140
    for dim_z in (3, 141):
        with pytest.raises(ValueError, match='must be a positive multiple'):
            biggan.BigGAN(resolution=256, ch=2, num_classes=2, dim_z=dim_z)
    with pytest.raises(ValueError):
        biggan.BigGAN(resolution=64, ch=2)
    model = biggan.BigGAN(resolution=256, ch=4, num_classes=5, attn_res=8)
    # blocks.0 upsamples 16ch -> 16ch and still carries its skip conv
    assert model.blocks[0].conv_sc is not None
    assert model.attn_after == 0
    names = set(model.state_dict())
    assert {'blocks.0.conv_sc.weight', 'attention.gamma',
            'blocks.0.bn1.bn.running_mean', 'output_bn.weight',
            'shared_embedding.weight'} <= names


def test_sample_draw():
    model = biggan.BigGAN(resolution=128, ch=4, num_classes=10, attn_res=16)
    biggan.init_generator(model, torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        model.attention.gamma.fill_(0.5)
    seen = []
    model.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    labels = [1, 3]
    a = biggan.sample(model, torch.Generator().manual_seed(7), labels, 0.5)
    b = biggan.sample(model, torch.Generator().manual_seed(7), labels, 0.5)
    c = biggan.sample(model, torch.Generator().manual_seed(8), labels, 0.5)
    assert a.shape == (2, 128, 128, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.abs().max() <= 1.0
    assert (a[0] - a[1]).abs().mean() > 1e-4        # classes apart
    z = seen[0]
    assert z.shape == (2, 120) and z.abs().max() <= 1.0 and z.std() > 0.2
    wide = biggan.truncated_normal((20000,), torch.Generator().manual_seed(0))
    assert wide.abs().max() <= 2.0 and 0.85 < float(wide.std()) < 0.9
    assert biggan.biggan128(num_classes=3, ch=2).training is False

