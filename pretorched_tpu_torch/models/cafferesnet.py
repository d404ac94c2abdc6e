"""CaffeResNet-101: the Caffe-port ResNet.

Counterpart of ``pretorched_tpu/models/cafferesnet.py`` (reference:
pretorched/models/cafferesnet.py) on the port's ``ResNet``: the
bottleneck's stride on its first 1x1 (``stride_on='conv1'``), the stem's
3x3 / 2 max pool unpadded in ceil mode (``stem_pool='ceil'``), a fixed 7x7
average pool head, and BGR input in [0, 255] in its metadata.
"""

from __future__ import annotations

from ..core.registry import image_settings, register_model, register_settings
from .resnet import ResNet

pretrained_settings = {
    'cafferesnet101': {
        'imagenet': image_settings(
            'http://data.lip6.fr/cadene/pretrainedmodels/cafferesnet101-9d633cc0.pth',
            input_space='BGR', input_range=(0, 255),
            mean=(102.9801, 115.9465, 122.7717), std=(1, 1, 1)),
    }
}


@register_model
def cafferesnet101(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """CaffeResNet-101 (stride on conv1, ceil-mode stem pool, BGR input)."""
    from ..core.factory import build_model
    model = ResNet('bottleneck', (3, 4, 23, 3), num_classes=num_classes,
                   stride_on='conv1', stem_pool='ceil', logits_pool='avg7')
    return build_model('cafferesnet101', model, pretrained_settings,
                       num_classes, pretrained)


register_settings(pretrained_settings)
