"""MobileNetV2.

Counterpart of ``pretorched_tpu/models/mobilenet.py`` (reference:
pretorched/models/mobilenet.py), in NCHW: inverted residuals with ReLU6
and depthwise 3x3 convs (``groups`` = channels); head: global mean,
dropout 0.2, ``last_linear``. The Sequential slots are the hosted file's
(``features.{i}.conv.{j}``, mobilenet.py:48-71).
"""

from __future__ import annotations

import torch.nn as nn

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import global_avg_pool
from .layers import batch_norm, conv2d, linear, register_features

pretrained_settings = {
    'mobilenetv2': {
        'imagenet': image_settings(
            'http://pretorched-x.csail.mit.edu/models/mobilenetv2-b190fe5f.pth'),
    }
}

# (expand_ratio, channels, repeats, stride) — mobilenet.py:88-96
_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _conv_bn(cin, cout, kernel, stride=1, padding=0, groups=1, act=True):
    layers = [conv2d(cin, cout, kernel, stride, padding, groups=groups),
              batch_norm(cout)]
    return layers + [nn.ReLU6()] if act else layers


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = round(cin * expand)
        self.use_res = stride == 1 and cin == cout
        layers = _conv_bn(cin, hidden, 1) if expand != 1 else []
        self.conv = nn.Sequential(
            *layers, *_conv_bn(hidden, hidden, 3, stride, 1, groups=hidden),
            *_conv_bn(hidden, cout, 1, act=False))

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(PretrainedModel):
    """Every field of the JAX ``MobileNetV2``."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0):
        last = int(1280 * width_mult) if width_mult > 1.0 else 1280
        super().__init__(num_classes, last)
        self.width_mult = width_mult
        cin = int(32 * width_mult)
        layers = [nn.Sequential(*_conv_bn(3, cin, 3, 2, 1))]
        for t, c, n, s in _SETTING:
            cout = int(c * width_mult)
            for i in range(n):
                layers.append(InvertedResidual(cin, cout, s if i == 0 else 1,
                                               t))
                cin = cout
        layers.append(nn.Sequential(*_conv_bn(cin, last, 1)))
        register_features(self, nn.Sequential(*layers))
        self.dropout = nn.Dropout(0.2)
        self.last_linear = linear(last, num_classes)

    def _features(self, x):
        return self._modules['features'](x)

    def _logits(self, features):
        return self.last_linear(self.dropout(global_avg_pool(features)))


@register_model
def mobilenetv2(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """MobileNetV2 (arXiv:1801.04381)."""
    from ..core.factory import build_model
    return build_model('mobilenetv2', MobileNetV2(num_classes),
                       pretrained_settings, num_classes, pretrained)


register_settings(pretrained_settings)
