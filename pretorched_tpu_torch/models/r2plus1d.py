"""R(2+1)D video ResNets (10..200).

Counterpart of ``pretorched_tpu/models/r2plus1d.py`` (reference:
pretorched/models/r2plus1d.py): ``VideoResNet(factored=True)``, whose stem,
bottleneck and downsample convs are factored spatial + temporal pairs with
the paper's intermediate width (r2plus1d.py:29-88); basic blocks keep plain
3x3x3 convs (r2plus1d.py:93-95). No hosted weights; the JAX package builds
them on 8-frame clips.
"""

from __future__ import annotations

from ..core.registry import register_model
from .resnet3d import VideoResNet

_CONFIGS = {
    'r2plus1d10': ('basic', (1, 1, 1, 1)),
    'r2plus1d18': ('basic', (2, 2, 2, 2)),
    'r2plus1d34': ('basic', (3, 4, 6, 3)),
    'r2plus1d50': ('bottleneck', (3, 4, 6, 3)),
    'r2plus1d101': ('bottleneck', (3, 4, 23, 3)),
    'r2plus1d152': ('bottleneck', (3, 8, 36, 3)),
    'r2plus1d200': ('bottleneck', (3, 24, 36, 3)),
}


def _factory(name):
    def fn(num_classes: int = 400, pretrained=None, shortcut_type: str = 'B'):
        from ..core.factory import build_model
        block, layers = _CONFIGS[name]
        model = VideoResNet(block, layers, num_classes=num_classes,
                            shortcut_type=shortcut_type, factored=True)
        return build_model(name, model, {name: {}}, num_classes, pretrained,
                           video=True)
    fn.__name__ = name
    fn.__doc__ = f'Constructs a {name} (factored spatio-temporal conv) model.'
    return register_model(fn, name=name)


r2plus1d10 = _factory('r2plus1d10')
r2plus1d18 = _factory('r2plus1d18')
r2plus1d34 = _factory('r2plus1d34')
r2plus1d50 = _factory('r2plus1d50')
r2plus1d101 = _factory('r2plus1d101')
r2plus1d152 = _factory('r2plus1d152')
r2plus1d200 = _factory('r2plus1d200')
