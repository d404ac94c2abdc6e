"""Inception v3 (torchvision weights).

Counterpart of ``pretorched_tpu/models/inception_v3.py`` (reference:
pretorched/models/torchvision_models.py:380-438), in NCHW with
torchvision's keys: 299 px, mean and std 0.5; ``logits`` = 8x8 average
pool, dropout 0.5, ``last_linear`` (the hosted file's ``fc``). The aux
head (``AuxLogits``) is always built, as JAX initializes with
``train=True`` so that its parameters exist (inception_v3.py:152-155). It
runs in train mode only: then ``forward`` returns ``(logits, aux)``, in
eval mode the logits alone (torchvision_models.py:395-426). So a train
step that puts ``forward``'s output into the loss fails on the tuple, as
JAX's ``make_train_step`` does: neither package weights an aux loss.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import BasicConv2d, linear

pretrained_settings = {
    'inceptionv3': {'imagenet': image_settings(
        'https://download.pytorch.org/models/inception_v3_google-1a9a5a14.pth',
        input_size=(3, 299, 299), mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))},
}


def _avg31(x):
    return avg_pool(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg31(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg31(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          max_pool(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([
            self.branch1x1(x), self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_avg31(x))], dim=1)


class InceptionAux(nn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.conv0 = BasicConv2d(cin, 128, 1)
        self.conv1 = BasicConv2d(128, 768, 5)
        self.fc = linear(768, num_classes)

    def forward(self, x):
        x = self.conv1(self.conv0(avg_pool(x, 5, 3)))
        return self.fc(x.flatten(1))


class InceptionV3(PretrainedModel):
    """Every field of the JAX ``InceptionV3``."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = True):
        super().__init__(num_classes, 2048)
        self.aux_logits = aux_logits
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.AuxLogits = InceptionAux(768, num_classes)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.dropout = nn.Dropout(0.5)
        self.last_linear = linear(2048, num_classes)

    def _trunk(self, x, aux: bool):
        """(features, the aux head's logits or None)."""
        x = self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x))
        x = max_pool(self.Conv2d_2b_3x3(x), 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool(x, 3, 2)
        for name in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a',
                     'Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e'):
            x = getattr(self, name)(x)
        side = self.AuxLogits(x) if aux else None
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return x, side

    def _features(self, x):
        return self._trunk(x, False)[0]

    def _logits(self, features):
        x = self.dropout(avg_pool(features, 8)).flatten(1)
        return self.last_linear(x)

    def forward(self, x):
        with self._autocast(x):
            features, aux = self._trunk(x, self.training and self.aux_logits)
            logits = self._logits(features)
        return logits if aux is None else (logits, aux)


TORCH_RENAMES = {'last_linear': 'fc'}


@register_model
def inceptionv3(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """Inception v3 ("Rethinking the Inception Architecture...")."""
    from ..core.factory import build_model
    return build_model('inceptionv3', InceptionV3(num_classes),
                       pretrained_settings, num_classes, pretrained,
                       torch_renames=TORCH_RENAMES)


register_settings(pretrained_settings)
