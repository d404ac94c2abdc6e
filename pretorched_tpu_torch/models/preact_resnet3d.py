"""Pre-activation ResNet3D (10..200).

Counterpart of ``pretorched_tpu/models/preact_resnet3d.py`` (reference:
pretorched/models/pre_act_resnet3D.py): ``VideoResNet(preact=True)``,
BN -> ReLU -> conv block ordering, no ReLU after the add; no hosted weights.
"""

from __future__ import annotations

from ..core.registry import register_model
from .resnet3d import VideoResNet

_CONFIGS = {
    'preact_resnet3d10': ('basic', (1, 1, 1, 1)),
    'preact_resnet3d18': ('basic', (2, 2, 2, 2)),
    'preact_resnet3d34': ('basic', (3, 4, 6, 3)),
    'preact_resnet3d50': ('bottleneck', (3, 4, 6, 3)),
    'preact_resnet3d101': ('bottleneck', (3, 4, 23, 3)),
    'preact_resnet3d152': ('bottleneck', (3, 8, 36, 3)),
    'preact_resnet3d200': ('bottleneck', (3, 24, 36, 3)),
}


def _factory(name):
    def fn(num_classes: int = 400, pretrained=None, shortcut_type: str = 'B'):
        from ..core.factory import build_model
        block, layers = _CONFIGS[name]
        model = VideoResNet(block, layers, num_classes=num_classes,
                            shortcut_type=shortcut_type, preact=True)
        return build_model(name, model, {name: {}}, num_classes, pretrained,
                           video=True)
    fn.__name__ = name
    fn.__doc__ = f'Constructs a {name} (pre-activation) video model.'
    return register_model(fn, name=name)


preact_resnet3d10 = _factory('preact_resnet3d10')
preact_resnet3d18 = _factory('preact_resnet3d18')
preact_resnet3d34 = _factory('preact_resnet3d34')
preact_resnet3d50 = _factory('preact_resnet3d50')
preact_resnet3d101 = _factory('preact_resnet3d101')
preact_resnet3d152 = _factory('preact_resnet3d152')
preact_resnet3d200 = _factory('preact_resnet3d200')
