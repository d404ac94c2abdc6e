"""Inception-v4 (TF port).

Counterpart of ``pretorched_tpu/models/inceptionv4.py`` (reference:
pretorched/models/inceptionv4.py), in NCHW with the hosted file's keys
(``features.0`` ... ``features.21``): ``BasicConv2d`` is a bias-free conv,
BN (eps 1e-3) and ReLU; the branch average pools are 3x3/1 padded 1 with
``count_include_pad=False``; the head is an 8x8 average pool (so 299 px)
into ``last_linear`` (1536). The hosted file has 1001 classes: an
``imagenet`` load drops the background row (inceptionv4.py:320-327).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import BasicConv2d, Concat, conv_seq, linear, register_features

_URL = 'http://pretorched-x.csail.mit.edu/models/inceptionv4-0f7d42d3.pth'
pretrained_settings = {
    'inceptionv4': {
        'imagenet': image_settings(_URL, input_size=(3, 299, 299),
                                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
        'imagenet+background': image_settings(
            _URL, input_size=(3, 299, 299), mean=(0.5, 0.5, 0.5),
            std=(0.5, 0.5, 0.5), num_classes=1001),
    }
}


def pool_branch(cin, cout):
    """3x3/1 average pool padded 1 (padding not counted), then a 1x1
    ``BasicConv2d``: the slots ``branch3.0`` (no parameters) and
    ``branch3.1``."""
    return nn.Sequential(nn.AvgPool2d(3, 1, 1, count_include_pad=False),
                         BasicConv2d(cin, cout, 1))


class Mixed3a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = BasicConv2d(64, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([max_pool(x, 3, 2), self.conv(x)], dim=1)


class Mixed5a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        return torch.cat([self.conv(x), max_pool(x, 3, 2)], dim=1)


def mixed_4a():
    return Concat(conv_seq(160, [(64, 1, 1, 0), (96, 3, 1, 0)]),
                  conv_seq(160, [(64, 1, 1, 0), (64, (1, 7), 1, (0, 3)),
                                 (64, (7, 1), 1, (3, 0)), (96, 3, 1, 0)]))


def inception_a():
    return Concat(BasicConv2d(384, 96, 1),
                  conv_seq(384, [(64, 1, 1, 0), (96, 3, 1, 1)]),
                  conv_seq(384, [(64, 1, 1, 0), (96, 3, 1, 1),
                                 (96, 3, 1, 1)]),
                  pool_branch(384, 96))


def reduction_a():
    return Concat(BasicConv2d(384, 384, 3, stride=2),
                  conv_seq(384, [(192, 1, 1, 0), (224, 3, 1, 1),
                                 (256, 3, 2, 0)]), pool=True)


def inception_b():
    return Concat(BasicConv2d(1024, 384, 1),
                  conv_seq(1024, [(192, 1, 1, 0), (224, (1, 7), 1, (0, 3)),
                                  (256, (7, 1), 1, (3, 0))]),
                  conv_seq(1024, [(192, 1, 1, 0), (192, (7, 1), 1, (3, 0)),
                                  (224, (1, 7), 1, (0, 3)),
                                  (224, (7, 1), 1, (3, 0)),
                                  (256, (1, 7), 1, (0, 3))]),
                  pool_branch(1024, 128))


def reduction_b():
    return Concat(conv_seq(1024, [(192, 1, 1, 0), (192, 3, 2, 0)]),
                  conv_seq(1024, [(256, 1, 1, 0), (256, (1, 7), 1, (0, 3)),
                                  (320, (7, 1), 1, (3, 0)), (320, 3, 2, 0)]),
                  pool=True)


class InceptionC(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(1536, 256, 1)
        self.branch1_0 = BasicConv2d(1536, 384, 1)
        self.branch1_1a = BasicConv2d(384, 256, (1, 3), padding=(0, 1))
        self.branch1_1b = BasicConv2d(384, 256, (3, 1), padding=(1, 0))
        self.branch2_0 = BasicConv2d(1536, 384, 1)
        self.branch2_1 = BasicConv2d(384, 448, (3, 1), padding=(1, 0))
        self.branch2_2 = BasicConv2d(448, 512, (1, 3), padding=(0, 1))
        self.branch2_3a = BasicConv2d(512, 256, (1, 3), padding=(0, 1))
        self.branch2_3b = BasicConv2d(512, 256, (3, 1), padding=(1, 0))
        self.branch3 = pool_branch(1536, 256)

    def forward(self, x):
        b1 = self.branch1_0(x)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        return torch.cat([self.branch0(x), self.branch1_1a(b1),
                          self.branch1_1b(b1), self.branch2_3a(b2),
                          self.branch2_3b(b2), self.branch3(x)], dim=1)


class InceptionV4(PretrainedModel):
    """Every field of the JAX ``InceptionV4``."""

    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 1536)
        register_features(self, nn.Sequential(
            BasicConv2d(3, 32, 3, stride=2), BasicConv2d(32, 32, 3),
            BasicConv2d(32, 64, 3, padding=1), Mixed3a(), mixed_4a(),
            Mixed5a(), *[inception_a() for _ in range(4)], reduction_a(),
            *[inception_b() for _ in range(7)], reduction_b(),
            *[InceptionC() for _ in range(3)]))
        self.last_linear = linear(1536, num_classes)

    def _features(self, x):
        return self._modules['features'](x)

    def _logits(self, features):
        x = avg_pool(features, 8, count_include_pad=False).flatten(1)
        return self.last_linear(x)


@register_model
def inceptionv4(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """Inception-v4 (arXiv:1602.07261); 'imagenet' drops the TF background
    class."""
    from ..core.factory import build_model
    background = ('last_linear',) if pretrained == 'imagenet' else ()
    return build_model('inceptionv4', InceptionV4(num_classes),
                       pretrained_settings, num_classes, pretrained,
                       background_class_keys=background)


register_settings(pretrained_settings)
