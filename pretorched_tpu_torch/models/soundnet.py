"""SoundNet (audio CNN) and BranchedSoundNet (objects and places heads).

Counterpart of ``pretorched_tpu/models/soundnet.py`` (reference:
pretorched/models/soundnet.py), on an (N, 1, L) waveform:

* seven conv1d -> BN -> ReLU stages (``_STAGES``), with stride-1 max pools
  of 8, 8 and 4 after stages 1, 2 and 5; then ``conv8`` (1000 channels,
  kernel 8, stride 2), ReLU and a channel-major flatten: 67,724 samples
  give 262 steps, 262,000 features;
* the head applies ``last_linear`` (``feature_dim`` -> classes) to every
  full ``feature_dim`` window but the last, plus one right-aligned last
  window, and averages them, so any length of at least one window works.

The BN layers ``bn1..bn7`` are real and learnable: the reference built
them inside ``forward``, fresh each call (a bug). A checkpoint without
them loads with ``strict=False``, which names them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import register_model
from ..core.wrapper import PretrainedModel
from .layers import batch_norm, linear

# (out_ch, kernel, stride, padding, pool_kernel or None)
_STAGES = ((16, 64, 2, 32, 8), (32, 32, 2, 16, 8), (64, 16, 2, 8, None),
           (128, 8, 2, 4, None), (256, 4, 2, 2, 4), (512, 4, 2, 2, None),
           (1024, 4, 2, 2, None))


def conv1d(in_ch, out_ch, kernel_size, stride=1, padding=0):
    """Conv1d with a bias that ``init_parameters`` fills with
    ``torch_conv_init`` (the JAX package's ``conv1d``)."""
    conv = nn.Conv1d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding)
    conv.jax_init = True
    return conv


class _Stages(nn.Module):
    """``conv1..conv7`` and ``bn1..bn7``, shared by both nets."""

    def _build_stages(self):
        cin = 1
        for i, (ch, k, s, p, _) in enumerate(_STAGES, start=1):
            setattr(self, f'conv{i}', conv1d(cin, ch, k, s, p))
            setattr(self, f'bn{i}', batch_norm(ch))
            cin = ch

    def _stages(self, x):
        for i, (_, _, _, _, pool) in enumerate(_STAGES, start=1):
            x = F.relu(getattr(self, f'bn{i}')(getattr(self, f'conv{i}')(x)))
            if pool:
                x = F.max_pool1d(x, pool, 1)
        return x


class SoundNet(PretrainedModel, _Stages):
    """Every field of the JAX ``SoundNet``."""

    def __init__(self, num_classes: int = 1000, feature_dim: int = 262000):
        super().__init__(num_classes, feature_dim)
        self._build_stages()
        self.conv8 = conv1d(1024, 1000, 8, 2)
        self.last_linear.jax_init = True
        self.feature_dim = feature_dim

    def _features(self, x):
        return F.relu(self.conv8(self._stages(x))).flatten(1)

    def _logits(self, features):
        fd = self.feature_dim
        total = features.shape[-1]
        if total < fd:
            raise ValueError(f'need >= {fd} features, got {total}')
        n_chunks = -(-total // fd)
        starts = [i * fd for i in range(n_chunks - 1)] + [total - fd]
        outs = [self.last_linear(features[:, st:st + fd]) for st in starts]
        return torch.stack(outs).mean(0)


class BranchedSoundNet(_Stages):
    """Dual-head SoundNet: ImageNet objects (``conv8_1``, ``last_linear1``,
    1000) and Places (``conv8_2``, ``last_linear2``, 365) on 67,724
    samples; ``forward`` returns both logits. Not in the registry, as in
    JAX."""

    def __init__(self):
        super().__init__()
        self._build_stages()
        self.conv8_1 = conv1d(1024, 1000, 8, 2)
        self.conv8_2 = conv1d(1024, 401, 8, 2)
        self.last_linear1 = linear(262000, 1000)
        self.last_linear2 = linear(105062, 365)

    def forward(self, x):
        x = self._stages(x)
        obj = F.relu(self.conv8_1(x)).flatten(1)
        plc = F.relu(self.conv8_2(x)).flatten(1)
        return self.last_linear1(obj), self.last_linear2(plc)


@register_model
def soundnet8(num_classes: int = 1000, pretrained=None,
              sample_length: int = 67724):
    """SoundNet-8. The reference loads a local ``soundnet8.pth`` with
    strict=False; placed in the weight cache, it loads so here."""
    from ..core.factory import build_model
    model = SoundNet(num_classes=num_classes)
    settings_map = {'soundnet8': {'imagenet': {
        'url': 'soundnet8.pth', 'input_space': 'waveform',
        'input_size': [1, sample_length], 'input_range': [-1, 1],
        'mean': [0.0], 'std': [1.0], 'num_classes': num_classes}}}
    model = build_model('soundnet8', model, settings_map, num_classes,
                        pretrained, strict=False)
    model.input_ndim = 3      # (N, 1, L)
    return model
