"""BigGAN class-conditional generator: the sampling path (BASELINE config 5).

Counterpart of ``pretorched_tpu/gan/biggan.py`` (the published architecture,
arXiv:1809.11096), computed in NCHW with the JAX module's names, so a carried
variable tree loads key for key (``zoo/convert.state_dict_from_flax``):

* hierarchical latent: z is split into one 20-dim chunk for the first linear
  and one a block (``latent_dim`` 120 at 128 px, 140 at 256 px); each
  block's chunk, concatenated with the shared class embedding, drives the
  gains and biases of its conditional batch norms;
* ``GBlock``: condBN -> ReLU -> 2x nearest upsample -> 3x3 conv -> condBN ->
  ReLU -> 3x3 conv, with a 1x1 ``conv_sc`` on the skip whenever the block
  upsamples or changes width (the published ``learnable_sc`` rule);
* one SAGAN ``SelfAttention`` after the block that reaches ``attn_res``
  (64 px): theta (C/8), phi (C/8) and g (C/2) are 1x1 convs, phi and g are
  max-pooled 2x2, so the attention reads N/4 keys and Cv = 4 C. It goes
  through ``auto_nonlocal_attention``: on a CUDA tensor that is the K1-fwd
  kernel (mma.sync in bf16, the scalar program in f32, since C is no
  multiple of 64 at these widths); on the CPU its plain version;
* head: BN -> ReLU -> 3x3 conv -> tanh.

``BigGAN.forward(z, labels)`` returns NCHW images in [-1, 1]; ``sample``
draws z from a normal truncated to [-2, 2] and returns them channels-last,
(B, res, res, 3), as the JAX ``sample`` does. bf16 sampling runs under
``torch.autocast``. The factories return the generator in eval mode (BN on
its running statistics, as the JAX ``apply`` uses them), initialized from a
seeded ``torch.Generator`` (the JAX versions return ``(module, variables)``).
SAGAN's ``gamma`` starts at 0, as published, which keeps the attention out
of the image until it is trained or set.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import batch_norm, conv2d, init_parameters, linear
from ..ops.cuda.nonlocal_attention import auto_nonlocal_attention
from ..ops.pooling import max_pool

CHUNK = 20       # published latent layout: 20 dims per z chunk


class CondBatchNorm(nn.Module):
    """BN without affine parameters, then a class- and latent-conditioned
    scale and shift: ``h * (1 + gain(cond)) + bias(cond)``."""

    def __init__(self, features: int, cond_dim: int):
        super().__init__()
        # flax momentum 0.9 (running-stat decay) is torch momentum 0.1
        self.bn = batch_norm(features, eps=1e-4, momentum=0.1, affine=False)
        self.gain = linear(cond_dim, features)
        self.bias = linear(cond_dim, features)

    def forward(self, x, cond):
        h = self.bn(x)
        return (h * (1.0 + self.gain(cond)[:, :, None, None])
                + self.bias(cond)[:, :, None, None])


class GBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cond_dim: int,
                 upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.bn1 = CondBatchNorm(in_ch, cond_dim)
        self.conv1 = conv2d(in_ch, out_ch, 3, padding=1, bias=True)
        self.bn2 = CondBatchNorm(out_ch, cond_dim)
        self.conv2 = conv2d(out_ch, out_ch, 3, padding=1, bias=True)
        self.conv_sc = (conv2d(in_ch, out_ch, 1, bias=True)
                        if upsample or in_ch != out_ch else None)

    def forward(self, x, cond):
        h = F.relu(self.bn1(x, cond))
        if self.upsample:
            h = F.interpolate(h, scale_factor=2, mode='nearest')
            x = F.interpolate(x, scale_factor=2, mode='nearest')
        h = self.conv2(F.relu(self.bn2(self.conv1(h), cond)))
        if self.conv_sc is not None:
            x = self.conv_sc(x)
        return h + x


class SelfAttention(nn.Module):
    """SAGAN attention over the H*W positions, keys pooled 2x2."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.theta = conv2d(c, c // 8, 1)
        self.phi = conv2d(c, c // 8, 1)
        self.g = conv2d(c, c // 2, 1)
        self.o = conv2d(c // 2, c, 1)
        self.gamma = nn.Parameter(torch.zeros(()))

    @staticmethod
    def _flat(t):
        """(B, C, H, W) -> (B, H*W, C), row-major over (h, w) like the JAX
        module's NHWC reshape."""
        return t.flatten(2).transpose(1, 2)

    def forward(self, x):
        b, _, h, w = x.shape
        theta = self._flat(self.theta(x))
        phi = self._flat(max_pool(self.phi(x), 2, 2))
        g = self._flat(max_pool(self.g(x), 2, 2))
        y = auto_nonlocal_attention(theta, phi, g)
        y = y.transpose(1, 2).reshape(b, -1, h, w)
        return x + self.gamma * self.o(y)


class BigGAN(nn.Module):
    """Generator. ``resolution`` in {128, 256}; ``ch`` the width base."""

    def __init__(self, resolution: int = 256, ch: int = 96, dim_z: int = 0,
                 shared_dim: int = 128, num_classes: int = 1000,
                 attn_res: int = 64):
        super().__init__()
        self.resolution, self.ch, self.dim_z = resolution, ch, dim_z
        self.shared_dim, self.num_classes = shared_dim, num_classes
        self.attn_res = attn_res
        blocks = list(self.arch)
        n_chunks = len(blocks) + 1
        self.chunk = self.latent_dim // n_chunks
        if self.chunk == 0 or self.chunk * n_chunks != self.latent_dim:
            # a non-divisible dim_z would silently discard the trailing z
            # dims, and dim_z < n_chunks would feed every block empty chunks
            raise ValueError(
                f'dim_z={self.latent_dim} must be a positive multiple of '
                f'{n_chunks} (one chunk for the first linear + one per '
                f'block; published layout is {CHUNK} per chunk)')
        cond_dim = shared_dim + self.chunk
        self.shared_embedding = nn.Embedding(num_classes, shared_dim)
        self.linear = linear(self.chunk, 4 * 4 * 16 * ch)
        mods, in_ch, res = [], 16 * ch, 4
        self.attn_after = None
        for i, mult in enumerate(blocks):
            mods.append(GBlock(in_ch, mult * ch, cond_dim))
            in_ch = mult * ch
            res *= 2
            if res == attn_res:
                self.attn_after = i
                self.attention = SelfAttention(in_ch)
        self.blocks = nn.ModuleList(mods)
        self.output_bn = batch_norm(in_ch, eps=1e-4, momentum=0.1)
        self.output_conv = conv2d(in_ch, 3, 3, padding=1, bias=True)

    @property
    def arch(self) -> Sequence[int]:
        if self.resolution == 256:
            return (16, 16, 8, 8, 4, 2)   # 4 -> 8 ... -> 256
        if self.resolution == 128:
            return (16, 16, 8, 4, 2)
        raise ValueError(self.resolution)

    @property
    def latent_dim(self) -> int:
        return self.dim_z or CHUNK * (len(self.arch) + 1)

    def forward(self, z, labels):
        zs = torch.split(z, self.chunk, dim=1)
        shared = self.shared_embedding(labels)
        # the JAX module reshapes the linear's output channels-last
        h = self.linear(zs[0]).view(-1, 4, 4, 16 * self.ch)
        h = h.permute(0, 3, 1, 2).contiguous()
        for i, block in enumerate(self.blocks):
            h = block(h, torch.cat([shared, zs[i + 1]], dim=1))
            if i == self.attn_after:
                h = self.attention(h)
        h = self.output_conv(F.relu(self.output_bn(h)))
        return torch.tanh(h)


@torch.no_grad()
def init_generator(model: BigGAN, generator: torch.Generator) -> BigGAN:
    """Every parameter of ``model`` from ``generator``: the convs and
    linears as the JAX package starts them (``layers.init_parameters``),
    the class embedding as flax's ``nn.Embed`` (a normal truncated to two
    standard deviations, variance 1 / shared_dim); ``gamma`` keeps its
    initial 0."""
    init_parameters(model, generator)
    emb = model.shared_embedding.weight
    # flax divides by the std of a standard normal truncated to [-2, 2]
    std = math.sqrt(1.0 / emb.shape[1]) / .87962566103423978
    emb.copy_(truncated_normal(emb.shape, generator, emb.device) * std)
    return model


def _build(resolution, ch, num_classes, seed=0):
    model = BigGAN(resolution=resolution, ch=ch, num_classes=num_classes)
    return init_generator(model, torch.Generator().manual_seed(seed)).eval()


def biggan128(num_classes: int = 1000, ch: int = 96) -> BigGAN:
    """BigGAN-128 generator, seeded weights, in eval mode."""
    return _build(128, ch, num_classes)


def biggan256(num_classes: int = 1000, ch: int = 96) -> BigGAN:
    """BigGAN-256 generator, seeded weights, in eval mode."""
    return _build(256, ch, num_classes)


def truncated_normal(shape, generator: torch.Generator, device=None,
                     lower: float = -2.0, upper: float = 2.0):
    """Standard normal truncated to [lower, upper], by the inverse CDF of a
    uniform draw from ``generator`` (on ``device``)."""
    cdf = [(1 + math.erf(v / math.sqrt(2))) / 2 for v in (lower, upper)]
    u = torch.rand(shape, generator=generator, device=device)
    u = u * (cdf[1] - cdf[0]) + cdf[0]
    return (torch.erfinv(2 * u - 1) * math.sqrt(2)).clamp_(lower, upper)


@torch.no_grad()
def sample(model: BigGAN, generator: torch.Generator, labels,
           truncation: float = 1.0):
    """Class-conditional sampling with the truncation trick: z from a normal
    truncated to [-2, 2], times ``truncation``, drawn from ``generator``
    (which lives on the model's device). Returns images in [-1, 1],
    channels-last (B, res, res, 3)."""
    device = next(model.parameters()).device
    labels = torch.as_tensor(labels, device=device)
    z = truncated_normal((labels.shape[0], model.latent_dim), generator,
                         device) * truncation
    return model(z, labels).permute(0, 2, 3, 1)
