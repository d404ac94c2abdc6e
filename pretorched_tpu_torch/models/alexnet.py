"""AlexNet (torchvision's 'one weird trick' variant).

Counterpart of ``pretorched_tpu/models/alexnet.py`` (reference:
pretorched/models/torchvision_models.py:198-246), in NCHW. ``features``
runs the conv stack (``features.0`` .. ``features.10``), flatten and the
classifier through ``linear1``, before its ReLU; ``logits`` is ReLU and
``last_linear``. The hosted files call ``linear0``, ``linear1`` and
``last_linear`` ``classifier.1``, ``.4`` and ``.6``.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from .layers import conv2d, linear, register_features

pretrained_settings = {
    'alexnet': {
        'imagenet': image_settings(
            'https://download.pytorch.org/models/alexnet-owt-4df8aa71.pth'),
        'places365': image_settings(
            'http://pretorched-x.csail.mit.edu/models/alexnet_places365-0c3a7b83.pth',
            num_classes=365),
    }
}


class AlexNet(PretrainedModel):
    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 4096)
        register_features(self, nn.Sequential(
            conv2d(3, 64, 11, stride=4, padding=2, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            conv2d(64, 192, 5, padding=2, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            conv2d(192, 384, 3, padding=1, bias=True), nn.ReLU(),
            conv2d(384, 256, 3, padding=1, bias=True), nn.ReLU(),
            conv2d(256, 256, 3, padding=1, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, 2)))
        self.dropout0 = nn.Dropout(0.5)
        self.linear0 = linear(256 * 6 * 6, 4096)
        self.dropout1 = nn.Dropout(0.5)
        self.linear1 = linear(4096, 4096)
        self.last_linear = linear(4096, num_classes)

    def _features(self, x):
        x = self._modules['features'](x).flatten(1)          # 256*6*6
        x = F.relu(self.linear0(self.dropout0(x)))
        return self.linear1(self.dropout1(x))

    def _logits(self, features):
        return self.last_linear(F.relu(features))


TORCH_RENAMES = {
    'linear0': 'classifier.1',
    'linear1': 'classifier.4',
    'last_linear': 'classifier.6',
}


@register_model
def alexnet(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """AlexNet ('One weird trick...' arXiv:1404.5997)."""
    from ..core.factory import build_model
    return build_model('alexnet', AlexNet(num_classes), pretrained_settings,
                       num_classes, pretrained, torch_renames=TORCH_RENAMES)


register_settings(pretrained_settings)
