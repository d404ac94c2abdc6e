"""ResNeXt3D (10..200): grouped-conv video ResNets.

Counterpart of ``pretorched_tpu/models/resnext3d.py`` (reference:
pretorched/models/resnext3D.py): cardinality-32 bottlenecks with expansion
2 and stage widths 128..1024 (resnext3D.py:76-121); only ``resnext3d101``
has hosted Kinetics weights. The settings are the JAX package's merged form
(the reference's settings loop overwrites datasets, resnext3D.py:37-49).
"""

from __future__ import annotations

from ..core.registry import register_model, register_settings
from .resnet3d import _KINETICS, TORCH_RENAMES, VideoResNet, video_settings

pretrained_settings = video_settings([
    'resnext3d10', 'resnext3d18', 'resnext3d34', 'resnext3d50',
    'resnext3d101', 'resnext3d152', 'resnext3d200'])

_LAYERS = {
    'resnext3d10': (1, 1, 1, 1), 'resnext3d18': (2, 2, 2, 2),
    'resnext3d34': (3, 4, 6, 3), 'resnext3d50': (3, 4, 6, 3),
    'resnext3d101': (3, 4, 23, 3), 'resnext3d152': (3, 8, 36, 3),
    'resnext3d200': (3, 24, 36, 3),
}


def _factory(name, default_pt):
    def fn(num_classes: int = 400, pretrained: str = default_pt,
           shortcut_type: str = 'B', cardinality: int = 32):
        from ..core.factory import build_model
        model = VideoResNet('bottleneck', _LAYERS[name],
                            num_classes=num_classes, expansion=2,
                            shortcut_type=shortcut_type,
                            cardinality=cardinality,
                            width_per_stage=(128, 256, 512, 1024))
        return build_model(name, model, pretrained_settings, num_classes,
                           pretrained, torch_renames=TORCH_RENAMES,
                           video=True)
    fn.__name__ = name
    fn.__doc__ = f'Constructs a {name} video model (cardinality 32).'
    return register_model(fn, name=name)


resnext3d10 = _factory('resnext3d10', None)
resnext3d18 = _factory('resnext3d18', None)
resnext3d34 = _factory('resnext3d34', None)
resnext3d50 = _factory('resnext3d50', None)
resnext3d101 = _factory('resnext3d101', _KINETICS)
resnext3d152 = _factory('resnext3d152', None)
resnext3d200 = _factory('resnext3d200', None)

register_settings(pretrained_settings)
