"""BN-Inception (Inception-v2, Caffe port).

Counterpart of ``pretorched_tpu/models/bninception.py`` (reference:
pretorched/models/bninception.py), in NCHW, built from the same table of
blocks. The keys are the Caffe port's flat names (``inception_3a_1x1``
and its ``inception_3a_1x1_bn``):

* BGR input in [0, 255], mean (104, 117, 128) (bninception.py:17-21);
* every conv has a bias; BN momentum 0.9 (torch's convention,
  bninception.py:33);
* every pool is in ceil mode; a block's pool branch is a 3x3/1 average
  padded 1 (count_include_pad), a max in block 5b, and in the stride-2
  blocks (3c, 4e) a 3x3/2 max with no projection and no 1x1 branch;
* branches concatenate as 1x1, 3x3, double 3x3, pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import avg_pool, max_pool
from .layers import batch_norm, conv2d, linear

pretrained_settings = {
    'bninception': {
        'imagenet': image_settings(
            'http://pretorched-x.csail.mit.edu/models/bn_inception-f8309acd.pth',
            input_space='BGR', input_range=(0, 255), mean=(104, 117, 128),
            std=(1, 1, 1)),
    }
}

# (name, 1x1, 3x3_reduce, 3x3, dbl_reduce, dbl_1, dbl_2, pool_proj, pool,
# stride), as the JAX package's table
_BLOCKS = (
    ('3a', 64, 64, 64, 64, 96, 96, 32, 'avg', 1),
    ('3b', 64, 64, 96, 64, 96, 96, 64, 'avg', 1),
    ('3c', 0, 128, 160, 64, 96, 96, 0, 'max', 2),
    ('4a', 224, 64, 96, 96, 128, 128, 128, 'avg', 1),
    ('4b', 192, 96, 128, 96, 128, 128, 128, 'avg', 1),
    ('4c', 160, 128, 160, 128, 160, 160, 128, 'avg', 1),
    ('4d', 96, 128, 192, 160, 192, 192, 128, 'avg', 1),
    ('4e', 0, 128, 192, 192, 256, 256, 0, 'max', 2),
    ('5a', 352, 192, 320, 160, 224, 224, 128, 'avg', 1),
    ('5b', 352, 192, 320, 192, 224, 224, 128, 'max', 1),
)


class BNInception(PretrainedModel):
    """Every field of the JAX ``BNInception``."""

    def __init__(self, num_classes: int = 1000):
        super().__init__(num_classes, 1024)
        self._cbr_layer('conv1_7x7_s2', 3, 64, 7, 2, 3)
        self._cbr_layer('conv2_3x3_reduce', 64, 64, 1)
        self._cbr_layer('conv2_3x3', 64, 192, 3, 1, 1)
        cin = 192
        for name, c1, r3, c3, rd, d1, d2, proj, _, stride in _BLOCKS:
            p = f'inception_{name}'
            if c1:
                self._cbr_layer(f'{p}_1x1', cin, c1, 1)
            self._cbr_layer(f'{p}_3x3_reduce', cin, r3, 1)
            self._cbr_layer(f'{p}_3x3', r3, c3, 3, stride, 1)
            self._cbr_layer(f'{p}_double_3x3_reduce', cin, rd, 1)
            self._cbr_layer(f'{p}_double_3x3_1', rd, d1, 3, 1, 1)
            self._cbr_layer(f'{p}_double_3x3_2', d1, d2, 3, stride, 1)
            if stride == 1:
                self._cbr_layer(f'{p}_pool_proj', cin, proj, 1)
            cin = c1 + c3 + d2 + (proj if stride == 1 else cin)
        self.last_linear = linear(1024, num_classes)

    def _cbr_layer(self, name, cin, cout, kernel, stride=1, padding=0):
        setattr(self, name, conv2d(cin, cout, kernel, stride, padding,
                                   bias=True))
        setattr(self, f'{name}_bn', batch_norm(cout, momentum=0.9))

    def _cbr(self, name, x):
        return F.relu(getattr(self, f'{name}_bn')(getattr(self, name)(x)))

    def _inception(self, x, cfg):
        name, c1, _, _, _, _, _, _, pool, stride = cfg
        p = f'inception_{name}'
        branches = [self._cbr(f'{p}_1x1', x)] if c1 else []
        branches.append(self._cbr(f'{p}_3x3', self._cbr(f'{p}_3x3_reduce', x)))
        b = self._cbr(f'{p}_double_3x3_reduce', x)
        b = self._cbr(f'{p}_double_3x3_1', b)
        branches.append(self._cbr(f'{p}_double_3x3_2', b))
        if stride == 2:
            branches.append(max_pool(x, 3, 2, 0, ceil_mode=True))
        else:
            pooled = (avg_pool(x, 3, 1, 1, ceil_mode=True) if pool == 'avg'
                      else max_pool(x, 3, 1, 1, ceil_mode=True))
            branches.append(self._cbr(f'{p}_pool_proj', pooled))
        return torch.cat(branches, dim=1)

    def _features(self, x):
        x = self._cbr('conv1_7x7_s2', x)
        x = max_pool(x, 3, 2, 0, ceil_mode=True)
        x = self._cbr('conv2_3x3', self._cbr('conv2_3x3_reduce', x))
        x = max_pool(x, 3, 2, 0, ceil_mode=True)
        for cfg in _BLOCKS:
            x = self._inception(x, cfg)
        return x

    def _logits(self, features):
        x = avg_pool(features, 7, 1, ceil_mode=True).flatten(1)
        return self.last_linear(x)


@register_model
def bninception(num_classes: int = 1000, pretrained: str = 'imagenet'):
    """BN-Inception (arXiv:1502.03167), Caffe-port weights."""
    from ..core.factory import build_model
    return build_model('bninception', BNInception(num_classes),
                       pretrained_settings, num_classes, pretrained)


register_settings(pretrained_settings)
