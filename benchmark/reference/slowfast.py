"""Plain float32 forward of SlowFast (Feichtenhofer et al., SlowFast Networks
for Video Recognition, arXiv:1812.03982), the pretorched-x
``slowfast_resnet50`` in mode 'sf'.

A function of a state dict under the program's key names (the JAX
package's flat names, ``fast.res2.0.conv1``) and of the configuration
file's sizes; no module of the program is imported.

* the clip's frames at stride ``fast_stride`` feed the Fast pathway, at
  ``slow_stride`` the Slow one;
* Fast: (5, 7, 7) stem conv to 8 channels at stride (1, 2, 2), BN, ReLU,
  (1, 3, 3) max pool at stride (1, 2, 2); four stages of bottlenecks with
  a temporal (3, 1, 1) first conv; after the pool and after each of the
  first three stages a lateral conv, kernel (5, 1, 1), stride (8, 1, 1),
  to twice the channels;
* Slow: (1, 7, 7) stem conv to 64 channels, the same BN, ReLU and pool;
  four stages whose input is the slow stream concatenated with the
  matching lateral; the first conv of a bottleneck is (1, 1, 1) in res2
  and res3, (3, 1, 1) from res4 on;
* bottleneck: conv1, BN, ReLU; (1, 3, 3) conv carrying the stride, BN,
  ReLU; 1x1x1 conv to 4x the planes, BN; plus the input, or its
  projection (1x1x1 conv at the stride and BN) where the shape changes;
  ReLU;
* head: each pathway's mean over (T, H, W), [slow, fast] concatenated,
  the bias-free linear layer (no dropout in eval).

No fused tail and no folded BN: each BN is applied from its own four
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nonlocalresnet3d import _bn
from .ops import Ops


def bottleneck(sd, key, x, stride, temporal, train, eps, ops):
    out = ops.conv(x, sd[f'{key}.conv1.weight'],
                   padding=(1, 0, 0) if temporal else 0)
    out = F.relu(_bn(sd, f'{key}.bn1', out, train, eps))
    out = ops.conv(out, sd[f'{key}.conv2.weight'], stride=(1, stride, stride),
                   padding=(0, 1, 1))
    out = F.relu(_bn(sd, f'{key}.bn2', out, train, eps))
    out = _bn(sd, f'{key}.bn3', ops.conv(out, sd[f'{key}.conv3.weight']),
              train, eps)
    if f'{key}.downsample.0.weight' in sd:
        x = _bn(sd, f'{key}.downsample.1', ops.conv(
            x, sd[f'{key}.downsample.0.weight'], stride=(1, stride, stride)),
            train, eps)
    return F.relu(out + x)


def _stem(sd, key, x, padding, train, eps, ops):
    x = ops.conv(x, sd[f'{key}.conv1.weight'], stride=(1, 2, 2),
                 padding=padding)
    x = F.relu(_bn(sd, f'{key}.bn1', x, train, eps))
    return F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


def _stage(sd, key, x, blocks, stride, temporal, train, eps, ops):
    for i in range(blocks):
        x = bottleneck(sd, f'{key}.{i}', x, stride if i == 0 else 1,
                       temporal, train, eps, ops)
    return x


def forward(sd, cfg, x, train=False, ops=None):
    """The logits of clips x (B, 3, T, H, W)."""
    ops = ops or Ops()
    arch = cfg['architecture']
    eps = arch['bn_eps']
    strides = arch['stage_strides']

    def lateral(name, t):
        return ops.conv(t, sd[f'fast.{name}.weight'], stride=(8, 1, 1),
                        padding=(2, 0, 0))

    fast = _stem(sd, 'fast', x[:, :, ::arch['fast_stride']], (2, 3, 3),
                 train, eps, ops)
    laterals = [lateral('lateral_p1', fast)]
    for i, (blocks, stride) in enumerate(zip(arch['layers'], strides)):
        fast = _stage(sd, f'fast.res{i + 2}', fast, blocks, stride, True,
                      train, eps, ops)
        if i < 3:
            laterals.append(lateral(f'lateral_res{i + 2}', fast))
    slow = _stem(sd, 'slow', x[:, :, ::arch['slow_stride']], (0, 3, 3),
                 train, eps, ops)
    for i, (blocks, stride, temporal) in enumerate(
            zip(arch['layers'], strides, arch['slow_temporal'])):
        slow = torch.cat([slow, laterals[i]], dim=1)
        slow = _stage(sd, f'slow.res{i + 2}', slow, blocks, stride,
                      temporal, train, eps, ops)
    features = torch.cat([slow.mean(dim=(2, 3, 4)),
                          fast.mean(dim=(2, 3, 4))], dim=1)
    return ops.linear(features, sd['last_linear.weight'])
