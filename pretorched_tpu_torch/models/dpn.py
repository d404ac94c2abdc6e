"""Dual Path Networks (dpn68, dpn68b, dpn92, dpn98, dpn107, dpn131).

Counterpart of ``pretorched_tpu/models/dpn.py`` (reference:
pretorched/models/dpn.py, Ross Wightman's port), in NCHW with the hosted
files' keys:

* pre-activation blocks (BN eps 1e-3, ReLU, conv); the residual and the
  dense path travel as a pair of tensors between blocks, each block's
  output a channel split of its last 1x1 (dpn.py:285-311); ``b`` (dpn68b)
  splits it into two convs after one BN;
* ``small`` (dpn68*): a 3x3/2 stem in place of 7x7/2;
* the classifier is a 1x1 conv with a bias (``classifier``), so there is
  no ``last_linear`` (None, as the JAX factory's ``head_path=None``) and
  ``reset_classifier`` raises. With ``test_time_pool`` the eval head is a
  7x7/1 average pool, the conv, and the mean of a global average and max
  pool (``adaptive_avgmax_pool2d``); in train mode it is a global average
  pool, then the conv (dpn.py:375-384);
* DPN's own mean and std (dpn.py:27-28). ``pretrained='default'`` names
  each net's hosted tag (``imagenet`` or ``imagenet+5k``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from ..ops.pooling import adaptive_avgmax_pool2d, avg_pool, global_avg_pool
from .layers import batch_norm, conv2d, register_features

_MEAN = (124 / 255, 117 / 255, 104 / 255)
_STD = (1 / (.0167 * 255),) * 3


def _s(url, **kw):
    return image_settings(url, mean=_MEAN, std=_STD, **kw)


_HOST = 'http://pretorched-x.csail.mit.edu/models/'
pretrained_settings = {
    'dpn68': {'imagenet': _s(_HOST + 'dpn68-fc785635.pth')},
    'dpn68b': {'imagenet+5k': _s(_HOST + 'dpn68b_extra-32ce864c.pth')},
    'dpn92': {'imagenet+5k': _s(_HOST + 'dpn92_extra-731473e5.pth')},
    'dpn98': {'imagenet': _s(_HOST + 'dpn98-865a0af1.pth')},
    'dpn131': {'imagenet': _s(_HOST + 'dpn131-fedf956c.pth')},
    'dpn107': {'imagenet+5k': _s(_HOST + 'dpn107_extra-6c815f6a.pth')},
}


def _bn(channels):
    return batch_norm(channels, eps=1e-3)


def _cat(x):
    return torch.cat(x, dim=1) if isinstance(x, tuple) else x


class BnActConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1):
        super().__init__()
        self.bn = _bn(cin)
        self.conv = conv2d(cin, cout, kernel, stride, padding, groups=groups)

    def forward(self, x):
        return self.conv(F.relu(self.bn(x)))


class CatBnAct(nn.Module):
    """The pair concatenated, BN, ReLU."""

    def __init__(self, channels):
        super().__init__()
        self.bn = _bn(channels)

    def forward(self, x):
        return F.relu(self.bn(_cat(x)))


class InputBlock(nn.Module):
    def __init__(self, features, small):
        super().__init__()
        k, p = (3, 1) if small else (7, 3)
        self.conv = conv2d(3, features, k, stride=2, padding=p)
        self.bn = _bn(features)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.bn(self.conv(x))), 3, 2, 1)


class DualPathBlock(nn.Module):
    """``block_type`` 'proj' (stride 1) or 'down' (stride 2) projects the
    input into a new pair; 'normal' keeps the pair it is given. Returns
    (residual, dense)."""

    def __init__(self, cin, r, bw, inc, groups, block_type, b):
        super().__init__()
        self.bw, self.inc, self.b = bw, inc, b
        self.block_type = block_type
        stride = 2 if block_type == 'down' else 1
        if block_type == 'proj':
            self.c1x1_w_s1 = BnActConv(cin, bw + 2 * inc, 1)
        elif block_type == 'down':
            self.c1x1_w_s2 = BnActConv(cin, bw + 2 * inc, 1, stride=2)
        self.c1x1_a = BnActConv(cin, r, 1)
        self.c3x3_b = BnActConv(r, r, 3, stride, 1, groups=groups)
        if b:
            self.c1x1_c = CatBnAct(r)
            self.c1x1_c1 = conv2d(r, bw, 1)
            self.c1x1_c2 = conv2d(r, inc, 1)
        else:
            self.c1x1_c = BnActConv(r, bw + inc, 1)

    def forward(self, x):
        x_in = _cat(x)
        if self.block_type == 'normal':
            x_s1, x_s2 = x
        else:
            proj = (self.c1x1_w_s1 if self.block_type == 'proj'
                    else self.c1x1_w_s2)
            x_s1, x_s2 = proj(x_in).split([self.bw, 2 * self.inc], dim=1)
        out = self.c3x3_b(self.c1x1_a(x_in))
        if self.b:
            out = self.c1x1_c(out)
            o1, o2 = self.c1x1_c1(out), self.c1x1_c2(out)
        else:
            out = self.c1x1_c(out)
            o1, o2 = out[:, :self.bw], out[:, self.bw:]
        return x_s1 + o1, torch.cat([x_s2, o2], dim=1)


class DPN(PretrainedModel):
    """Every field of the JAX ``DPN``."""

    def __init__(self, small: bool = False, num_init_features: int = 64,
                 k_r: int = 96, groups: int = 32, b: bool = False,
                 k_sec=(3, 4, 20, 3), inc_sec=(16, 32, 24, 128),
                 num_classes: int = 1000, test_time_pool: bool = False):
        bw_factor = 1 if small else 4
        blocks = OrderedDict(conv1_1=InputBlock(num_init_features, small))
        cin = num_init_features
        for stage, base in enumerate((64, 128, 256, 512), start=2):
            bw = base * bw_factor
            inc = inc_sec[stage - 2]
            r = (k_r * bw) // (64 * bw_factor)
            blocks[f'conv{stage}_1'] = DualPathBlock(
                cin, r, bw, inc, groups, 'proj' if stage == 2 else 'down', b)
            cin = bw + 3 * inc
            for i in range(2, k_sec[stage - 2] + 1):
                blocks[f'conv{stage}_{i}'] = DualPathBlock(
                    cin, r, bw, inc, groups, 'normal', b)
                cin += inc
        blocks['conv5_bn_ac'] = CatBnAct(cin)
        super().__init__(num_classes, cin)
        self.small, self.b = small, b
        self.test_time_pool = test_time_pool
        register_features(self, nn.Sequential(blocks))
        self.classifier = conv2d(cin, num_classes, 1, bias=True)
        self.last_linear = None

    def _features(self, x):
        return self._modules['features'](x)

    def _logits(self, features):
        if not self.training and self.test_time_pool:
            out = self.classifier(avg_pool(features, 7, 1))
            out = adaptive_avgmax_pool2d(out, 'avgmax')
        else:
            out = self.classifier(global_avg_pool(features, keepdims=True))
        return out.flatten(1)

    def reset_classifier(self, num_classes, generator=None):
        raise ValueError(f'{self.name} has no linear head')


_CONFIGS = {
    'dpn68': dict(small=True, num_init_features=10, k_r=128, groups=32,
                  k_sec=(3, 4, 12, 3), inc_sec=(16, 32, 32, 64)),
    'dpn68b': dict(small=True, num_init_features=10, k_r=128, groups=32, b=True,
                   k_sec=(3, 4, 12, 3), inc_sec=(16, 32, 32, 64)),
    'dpn92': dict(num_init_features=64, k_r=96, groups=32,
                  k_sec=(3, 4, 20, 3), inc_sec=(16, 32, 24, 128)),
    'dpn98': dict(num_init_features=96, k_r=160, groups=40,
                  k_sec=(3, 6, 20, 3), inc_sec=(16, 32, 32, 128)),
    'dpn131': dict(num_init_features=128, k_r=160, groups=40,
                   k_sec=(4, 8, 28, 3), inc_sec=(16, 32, 32, 128)),
    'dpn107': dict(num_init_features=128, k_r=200, groups=50,
                   k_sec=(4, 8, 20, 3), inc_sec=(20, 64, 64, 128)),
}
_DEFAULT_TAG = {'dpn68': 'imagenet', 'dpn68b': 'imagenet+5k',
                'dpn92': 'imagenet+5k', 'dpn98': 'imagenet',
                'dpn131': 'imagenet', 'dpn107': 'imagenet+5k'}


def _factory(name):
    def fn(num_classes: int = 1000, pretrained: str = None):
        from ..core.factory import build_model
        pretrained = (_DEFAULT_TAG[name] if pretrained == 'default'
                      else pretrained)
        model = DPN(num_classes=num_classes, test_time_pool=True,
                    **_CONFIGS[name])
        return build_model(name, model, pretrained_settings, num_classes,
                           pretrained)
    fn.__name__ = name
    fn.__defaults__ = (1000, _DEFAULT_TAG[name])
    fn.__doc__ = f'{name} (Dual Path Network).'
    return register_model(fn, name=name)


dpn68 = _factory('dpn68')
dpn68b = _factory('dpn68b')
dpn92 = _factory('dpn92')
dpn98 = _factory('dpn98')
dpn131 = _factory('dpn131')
dpn107 = _factory('dpn107')

register_settings(pretrained_settings)
