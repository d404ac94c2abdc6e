"""Inception-ResNet-v2 (TF port).

Counterpart of ``pretorched_tpu/models/inceptionresnetv2.py`` (reference:
pretorched/models/inceptionresnetv2.py), in NCHW with the hosted file's
keys: ``BasicConv2d`` (bias-free conv, BN eps 1e-3, ReLU); each residual
block scales its branch output (0.17 / 0.10 / 0.20) before the add, its
1x1 ``conv2d`` has a bias, and the last ``Block8`` (``block8``) has scale
1 and no ReLU; the head is ``conv2d_7b`` (1536), an 8x8 average pool (so
299 px) and ``last_linear``. The hosted file has 1001 classes: an
``imagenet`` load drops the background row
(inceptionresnetv2.py:343-350).
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .inceptionv4 import pool_branch
from .layers import BasicConv2d, Concat, conv2d, conv_seq, linear

_URL = 'http://pretorched-x.csail.mit.edu/models/inceptionresnetv2-c2ef1dee.pth'
pretrained_settings = {
    'inceptionresnetv2': {
        'imagenet': image_settings(_URL, input_size=(3, 299, 299),
                                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
        'imagenet+background': image_settings(
            _URL, input_size=(3, 299, 299), mean=(0.5, 0.5, 0.5),
            std=(0.5, 0.5, 0.5), num_classes=1001),
    }
}


class _Residual(Concat):
    """``relu(conv2d(cat(branches)) * scale + x)`` (no ReLU with
    ``relu=False``)."""

    def __init__(self, branches, width, channels, scale, relu=True):
        super().__init__(*branches)
        self.conv2d = conv2d(width, channels, 1, bias=True)
        self.scale, self.relu = scale, relu

    def forward(self, x):
        out = self.conv2d(super().forward(x)) * self.scale + x
        return F.relu(out) if self.relu else out


def block35(scale=0.17):
    return _Residual([BasicConv2d(320, 32, 1),
                      conv_seq(320, [(32, 1, 1, 0), (32, 3, 1, 1)]),
                      conv_seq(320, [(32, 1, 1, 0), (48, 3, 1, 1),
                                     (64, 3, 1, 1)])], 128, 320, scale)


def block17(scale=0.10):
    return _Residual([BasicConv2d(1088, 192, 1),
                      conv_seq(1088, [(128, 1, 1, 0), (160, (1, 7), 1, (0, 3)),
                                      (192, (7, 1), 1, (3, 0))])], 384, 1088,
                     scale)


def block8(scale=0.20, relu=True):
    return _Residual([BasicConv2d(2080, 192, 1),
                      conv_seq(2080, [(192, 1, 1, 0), (224, (1, 3), 1, (0, 1)),
                                      (256, (3, 1), 1, (1, 0))])], 448, 2080,
                     scale, relu)


class InceptionResNetV2(PretrainedModel):
    """Every field of the JAX ``InceptionResNetV2``."""

    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 1536)
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.mixed_5b = Concat(
            BasicConv2d(192, 96, 1),
            conv_seq(192, [(48, 1, 1, 0), (64, 5, 1, 2)]),
            conv_seq(192, [(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)]),
            pool_branch(192, 64))
        self.repeat = nn.Sequential(*[block35() for _ in range(10)])
        self.mixed_6a = Concat(
            BasicConv2d(320, 384, 3, stride=2),
            conv_seq(320, [(256, 1, 1, 0), (256, 3, 1, 1), (384, 3, 2, 0)]),
            pool=True)
        self.repeat_1 = nn.Sequential(*[block17() for _ in range(20)])
        self.mixed_7a = Concat(
            conv_seq(1088, [(256, 1, 1, 0), (384, 3, 2, 0)]),
            conv_seq(1088, [(256, 1, 1, 0), (288, 3, 2, 0)]),
            conv_seq(1088, [(256, 1, 1, 0), (288, 3, 1, 1), (320, 3, 2, 0)]),
            pool=True)
        self.repeat_2 = nn.Sequential(*[block8() for _ in range(9)])
        self.block8 = block8(scale=1.0, relu=False)
        self.conv2d_7b = BasicConv2d(2080, 1536, 1)
        self.last_linear = linear(1536, num_classes)

    def _features(self, x):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4a(self.conv2d_3b(max_pool(x, 3, 2)))
        x = self.mixed_6a(self.repeat(self.mixed_5b(max_pool(x, 3, 2))))
        x = self.mixed_7a(self.repeat_1(x))
        return self.conv2d_7b(self.block8(self.repeat_2(x)))

    def _logits(self, features):
        x = avg_pool(features, 8, count_include_pad=False).flatten(1)
        return self.last_linear(x)


@register_model
def inceptionresnetv2(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """Inception-ResNet-v2 (arXiv:1602.07261)."""
    from ..core.factory import build_model
    background = ('last_linear',) if pretrained == 'imagenet' else ()
    return build_model('inceptionresnetv2', InceptionResNetV2(num_classes),
                       pretrained_settings, num_classes, pretrained,
                       background_class_keys=background)


register_settings(pretrained_settings)
