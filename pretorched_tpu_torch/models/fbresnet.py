"""FBResNet: the Facebook Torch7 ResNet ports.

Counterpart of ``pretorched_tpu/models/fbresnet.py`` (reference:
pretorched/models/fbresnet.py) on the port's ``ResNet``: every conv carries
a bias (``conv_bias``) and the head pool is a fixed 7x7 average pool
(``logits_pool='avg7'``). Only ``fbresnet152`` has hosted weights; 18, 34,
50 and 101 are weightless constructors that refuse a ``pretrained`` name.
"""

from __future__ import annotations

from ..core.registry import image_settings, register_model, register_settings
from .resnet import ResNet

pretrained_settings = {
    'fbresnet152': {
        'imagenet': image_settings(
            'http://pretorched-x.csail.mit.edu/models/fbresnet152-3ade0e00.pth'),
    }
}

CONFIGS = {
    'fbresnet18': ('basic', (2, 2, 2, 2)),
    'fbresnet34': ('basic', (3, 4, 6, 3)),
    'fbresnet50': ('bottleneck', (3, 4, 6, 3)),
    'fbresnet101': ('bottleneck', (3, 4, 23, 3)),
    'fbresnet152': ('bottleneck', (3, 8, 36, 3)),
}


def _model(name, num_classes):
    block, layers = CONFIGS[name]
    return ResNet(block, layers, num_classes=num_classes, conv_bias=True,
                  logits_pool='avg7')


def _factory(name, default):
    def fn(num_classes: int = 1000, pretrained=default):
        from ..core.factory import build_model
        if pretrained is not None and name not in pretrained_settings:
            raise ValueError(f'{name} has no hosted pretrained weights')
        return build_model(name, _model(name, num_classes),
                           pretrained_settings, num_classes, pretrained)
    fn.__name__ = name
    fn.__doc__ = f'{name}: Torch7-port ResNet (convs with bias).'
    return register_model(fn, name=name)


fbresnet18 = _factory('fbresnet18', None)
fbresnet34 = _factory('fbresnet34', None)
fbresnet50 = _factory('fbresnet50', None)
fbresnet101 = _factory('fbresnet101', None)
fbresnet152 = _factory('fbresnet152', 'imagenet')

register_settings(pretrained_settings)
