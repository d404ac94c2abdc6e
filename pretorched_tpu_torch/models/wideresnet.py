"""WideResNet-50-2 (2D), the functional-zoo hickle export.

Counterpart of ``pretorched_tpu/models/wideresnet.py``: the hosted file
(``wide-resnet-50-2-export.hkl``) is BN-free, its batch norms folded into
conv biases, so the net is the port's ``ResNet`` with ``no_bn=True``,
``conv_bias=True``, the bottleneck's inner widths doubled and the 7x7
average-pool head. ``hkl_renames`` maps the port's keys to the export's
(``group{g}.block{i}.conv{0,1,2}``, ``conv_dim``, ``conv0``, ``fc``); the
loader reads ``.hkl`` through ``h5py`` and ``.npz`` without it. As in the
JAX package, the factory stays out of ``model_names`` and of the
aggregated ``pretrained_settings``.
"""

from __future__ import annotations

from ..core.registry import image_settings, register_model, register_settings
from .resnet import ResNet

LAYERS = (3, 4, 6, 3)

pretrained_settings = {
    'wideresnet50': {
        'imagenet': image_settings(
            'http://pretorched-x.csail.mit.edu/models/wide-resnet-50-2-export.hkl'),
    }
}


def hkl_renames() -> dict:
    """Port prefix -> hkl key prefix of the functional WRN-50-2 export
    (reference wideresnet.py:20-47)."""
    r = {'conv1': 'conv0', 'last_linear': 'fc'}
    for g, n in enumerate(LAYERS):
        for i in range(n):
            for c in range(3):
                r[f'layer{g + 1}.{i}.conv{c + 1}'] = f'group{g}.block{i}.conv{c}'
            r[f'layer{g + 1}.{i}.downsample.0'] = f'group{g}.block{i}.conv_dim'
    return r


@register_model
def wideresnet50(num_classes: int = 1000, pretrained=None):
    """Wide ResNet-50-2: bottleneck widths doubled; the BN-free conv and
    bias forward of the hosted hickle export."""
    from ..core.factory import build_model
    model = ResNet('bottleneck', LAYERS, num_classes=num_classes,
                   inner_width_mult=2.0, conv_bias=True, no_bn=True,
                   logits_pool='avg7')
    return build_model('wideresnet50', model, pretrained_settings,
                       num_classes, pretrained, torch_renames=hkl_renames())


register_settings(pretrained_settings, in_settings_registry=False)
