"""Xception.

Counterpart of ``pretorched_tpu/models/xception.py`` (reference:
pretorched/models/xception.py), in NCHW. A separable conv is a bias-free
depthwise 3x3 (``groups`` = channels) and a pointwise 1x1. Each block's
``rep`` Sequential holds its ReLUs too, so its slot indices are the hosted
file's (``block1.rep.0.conv1``, ``block2.rep.1.pointwise``); the ReLUs are
not in place, so the skip path sees the block's input. The eval resize
uses the model's ``scale`` (0.8975, xception.py:44).
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import global_avg_pool, max_pool
from .layers import batch_norm, conv2d, linear

pretrained_settings = {
    'xception': {
        'imagenet': image_settings(
            'http://pretorched-x.csail.mit.edu/models/xception-b429252d.pth',
            input_size=(3, 299, 299), mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
            scale=0.8975),
    }
}


class SeparableConv2d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = conv2d(cin, cin, 3, padding=1, groups=cin)
        self.pointwise = conv2d(cin, cout, 1)

    def forward(self, x):
        return self.pointwise(self.conv1(x))


class Block(nn.Module):
    def __init__(self, cin, cout, reps, stride=1, start_with_relu=True,
                 grow_first=True):
        super().__init__()
        widths = [cout] * reps if grow_first else [cin] * (reps - 1) + [cout]
        rep, ch = [], cin
        for w in widths:
            rep += [nn.ReLU(), SeparableConv2d(ch, w), batch_norm(w)]
            ch = w
        self.rep = nn.Sequential(*(rep if start_with_relu else rep[1:]))
        self.stride = stride
        if cout != cin or stride != 1:
            self.skip = conv2d(cin, cout, 1, stride=stride)
            self.skipbn = batch_norm(cout)
        else:
            self.skip = None

    def forward(self, x):
        y = self.rep(x)
        if self.stride != 1:
            y = max_pool(y, 3, self.stride, 1)
        return y + (x if self.skip is None else self.skipbn(self.skip(x)))


class Xception(PretrainedModel):
    """Every field of the JAX ``Xception``."""

    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 2048)
        self.conv1 = conv2d(3, 32, 3, stride=2)
        self.bn1 = batch_norm(32)
        self.conv2 = conv2d(32, 64, 3)
        self.bn2 = batch_norm(64)
        self.block1 = Block(64, 128, 2, 2, start_with_relu=False)
        self.block2 = Block(128, 256, 2, 2)
        self.block3 = Block(256, 728, 2, 2)
        for i in range(4, 12):
            setattr(self, f'block{i}', Block(728, 728, 3))
        self.block12 = Block(728, 1024, 2, 2, grow_first=False)
        self.conv3 = SeparableConv2d(1024, 1536)
        self.bn3 = batch_norm(1536)
        self.conv4 = SeparableConv2d(1536, 2048)
        self.bn4 = batch_norm(2048)
        self.last_linear = linear(2048, num_classes)

    def _features(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for i in range(1, 13):
            x = getattr(self, f'block{i}')(x)
        x = F.relu(self.bn3(self.conv3(x)))
        return self.bn4(self.conv4(x))

    def _logits(self, features):
        return self.last_linear(global_avg_pool(F.relu(features)))


TORCH_RENAMES = {'last_linear': 'fc'}


@register_model
def xception(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """Xception (arXiv:1610.02357)."""
    from ..core.factory import build_model
    return build_model('xception', Xception(num_classes), pretrained_settings,
                       num_classes, pretrained, torch_renames=TORCH_RENAMES)


register_settings(pretrained_settings)
