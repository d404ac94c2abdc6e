"""Plain float32 forward of the I3D ResNet with embedded-Gaussian non-local
blocks (Wang et al., Non-local Neural Networks, arXiv:1711.07971; the
pretorched-x ``nonlocalresnet3d50``, nonlocalnet.py:423-568).

A function of a state dict under the published checkpoint's key names and
of the configuration file's sizes; no module of the program is imported.

* stem: 7x7x7 conv at stride (1, 2, 2), padding 3, BN, ReLU, 3x3x3 max pool
  at stride 2, padding 1;
* four stages of bottlenecks (1x1x1, 3x3x3 carrying the stride, 1x1x1 to
  4x the planes), shortcut A: the input subsampled by the stride and its
  new channels zero (no parameters);
* a non-local block after blocks 0, 2, ... of a stage that has them
  (``blocks // count`` apart): 1x1x1 convs g, theta, phi to half the
  channels, y = softmax(theta phi^T) g over all T*H*W positions (no
  scale), a 1x1x1 conv and BN back, plus the input;
* head: the mean over (T, H, W), then the linear layer.

Batch norm normalizes with the batch's statistics in train mode, with the
running ones in eval mode. The attention is computed in blocks of query
rows, exactly (each row's softmax whole), so that it fits the card.
Departures from the paper, as the program and the hosted checkpoint have
them: no dropout before the head, shortcut A, 5 blocks at [0, 2, 3, 0].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import Ops

ROWS = 2048     # query rows a block of the attention


def _bn(sd, key, x, train, eps):
    return F.batch_norm(x, None if train else sd[f'{key}.running_mean'],
                        None if train else sd[f'{key}.running_var'],
                        sd[f'{key}.weight'], sd[f'{key}.bias'], train, 0.0,
                        eps)


def attention(q, k, v, ops):
    """softmax(q k^T) v of (B, N, C), (B, Nk, C), (B, Nk, Cv)."""
    kt = k.transpose(1, 2)
    outs = [ops.bmm(torch.softmax(ops.bmm(q[:, i:i + ROWS], kt), dim=-1), v)
            for i in range(0, q.shape[1], ROWS)]
    return torch.cat(outs, dim=1)


def nonlocal_block(sd, key, x, train, eps, ops):
    b = x.shape[0]
    spatial = x.shape[2:]

    def proj(name):
        y = ops.conv(x, sd[f'{key}.{name}.weight'], sd[f'{key}.{name}.bias'])
        return y.flatten(2).transpose(1, 2)

    y = attention(proj('theta'), proj('phi'), proj('g'), ops)
    y = y.transpose(1, 2).reshape(b, -1, *spatial)
    y = ops.conv(y, sd[f'{key}.W.0.weight'], sd[f'{key}.W.0.bias'])
    return _bn(sd, f'{key}.W.1', y, train, eps) + x


def bottleneck(sd, key, x, stride, out_ch, train, eps, ops):
    out = F.relu(_bn(sd, f'{key}.bn1', ops.conv(x, sd[f'{key}.conv1.weight']),
                     train, eps))
    out = F.relu(_bn(sd, f'{key}.bn2', ops.conv(
        out, sd[f'{key}.conv2.weight'], stride=stride, padding=1), train, eps))
    out = _bn(sd, f'{key}.bn3', ops.conv(out, sd[f'{key}.conv3.weight']),
              train, eps)
    short = x[:, :, ::stride, ::stride, ::stride]
    if short.shape[1] < out_ch:
        short = F.pad(short, (0, 0, 0, 0, 0, 0, 0, out_ch - short.shape[1]))
    return F.relu(out + short)


def forward(sd, cfg, x, train=False, ops=None):
    """The logits of clips x (B, 3, T, H, W)."""
    ops = ops or Ops()
    arch = cfg['architecture']
    eps = arch['bn_eps']
    stem = arch['stem']
    x = ops.conv(x, sd['conv1.weight'], stride=stem['stride'],
                 padding=stem['padding'])
    x = F.relu(_bn(sd, 'bn1', x, train, eps))
    x = F.max_pool3d(x, 3, 2, 1)
    for stage, (planes, blocks, nl) in enumerate(
            zip(arch['widths'], arch['layers'], arch['nonlocal_layers']),
            start=1):
        every = blocks // nl if nl else 0
        out_ch = planes * arch['expansion']
        for i in range(blocks):
            stride = 2 if stage > 1 and i == 0 else 1
            key = f'layer{stage}.{i}'
            x = bottleneck(sd, key, x, stride, out_ch, train, eps, ops)
            if every and i % every == 0:
                x = nonlocal_block(sd, f'{key}.nonlocalblock', x, train, eps,
                                   ops)
    return ops.linear(x.mean(dim=(2, 3, 4)), sd['last_linear.weight'],
                      sd['last_linear.bias'])
