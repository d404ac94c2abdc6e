"""VGG-M (Torch7 port).

Counterpart of ``pretorched_tpu/models/vggm.py`` (reference:
pretorched/models/vggm.py), in NCHW: BGR [0, 255] input at 221 px;
cross-map LRN after the first two conv stages; ceil-mode max pools; the
flattened 512 x 6 x 6 map (torch order, 18,432 wide) into ``classif``.
The hosted file names the last linear ``classif.6``. As in the JAX
package, the factory is registered but kept out of ``model_names`` and of
the aggregated ``pretrained_settings``.
"""

from __future__ import annotations

import torch.nn as nn

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.lrn import SpatialCrossMapLRN
from .layers import conv2d, linear, register_features

pretrained_settings = {
    'vggm': {
        'imagenet': image_settings(
            'http://data.lip6.fr/cadene/pretrainedmodels/vggm-786f2434.pth',
            input_space='BGR', input_size=(3, 221, 221), input_range=(0, 255),
            mean=(123.68, 116.779, 103.939), std=(1, 1, 1)),
    }
}


def _pool():
    return nn.MaxPool2d(3, 2, ceil_mode=True)


class VGGM(PretrainedModel):
    """Every field of the JAX ``VGGM``; the Sequential slots are the
    hosted file's (``features.0`` ... ``features.12``, ``classif.0`` and
    ``classif.3``)."""

    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 4096)
        register_features(self, nn.Sequential(
            conv2d(3, 96, 7, stride=2, bias=True), nn.ReLU(),
            SpatialCrossMapLRN(5, 0.0005, 0.75, 2), _pool(),
            conv2d(96, 256, 5, stride=2, padding=1, bias=True), nn.ReLU(),
            SpatialCrossMapLRN(5, 0.0005, 0.75, 2), _pool(),
            conv2d(256, 512, 3, padding=1, bias=True), nn.ReLU(),
            conv2d(512, 512, 3, padding=1, bias=True), nn.ReLU(),
            conv2d(512, 512, 3, padding=1, bias=True), nn.ReLU(), _pool()))
        self.classif = nn.Sequential(
            linear(18432, 4096), nn.ReLU(), nn.Dropout(0.5),
            linear(4096, 4096), nn.ReLU(), nn.Dropout(0.5))
        self.last_linear = linear(4096, num_classes)

    def _features(self, x):
        return self._modules['features'](x)

    def _logits(self, features):
        return self.last_linear(self.classif(features.flatten(1)))


TORCH_RENAMES = {'last_linear': 'classif.6'}


@register_model
def vggm(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """VGG-M (Torch7 port; BGR/255 input, LRN)."""
    from ..core.factory import build_model
    return build_model('vggm', VGGM(num_classes), pretrained_settings,
                       num_classes, pretrained, torch_renames=TORCH_RENAMES)


# the reference keeps vggm out of settings.py's registry (SURVEY §2.6)
register_settings(pretrained_settings, in_settings_registry=False)
