"""Temporal Relation Networks.

Counterpart of ``pretorched_tpu/models/trn.py`` (reference:
pretorched/models/trn.py). A 2D backbone runs per frame; relation heads
reason over ordered frame-feature subsets:

* ``Relation``: an MLP over the concatenation of n ordered frames
  (keys ``relate.1``, ``relate.3``);
* ``MultiScaleRelation``: sums relations over k subsets of the
  m-frame combinations for every scale m in [n..2]. With no generator it
  takes the first k combinations, as the JAX module does without its
  ``relation_sample`` rng; with a ``torch.Generator`` it draws k distinct
  combinations from it (the reference draws them with np.random.choice,
  trn.py:100-110; no draw matches JAX's PRNG bit for bit);
* ``HierarchicalRelation`` and ``MultiScaleHierarchicalRelation``:
  recursive neighbourhood relations, the JAX module's repair of the
  reference (each level's linear summed over its windows, the mean over
  levels);
* ``TRN``: the backbone (a model of this registry, its head dropped, as
  ``base_module``), dropout, the relation head (``temporal_relation``) and
  ``last_linear``. Its input is a video batch (N, C, T, H, W) with T a
  multiple of ``num_segments``; each frame goes through the backbone.

``bfloat16()`` reaches the backbone: the backbone runs inside TRN's
autocast, and its own ``compute_dtype`` is set with TRN's.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import image_settings, register_model, register_settings
from ..core.wrapper import PretrainedModel
from .layers import Identity, init_parameters, linear

pretrained_settings = {
    'trn': {
        'moments': image_settings('', num_classes=339),  # URL empty in reference (trn.py:13)
    }
}


class Relation(nn.Module):
    """MLP over n concatenated ordered inputs (reference: trn.py:20-56):
    (B, ..., num_inputs, in_features) -> (B, -1, out_features)."""

    def __init__(self, num_inputs: int, in_features: int, out_features: int,
                 bottleneck_dim: int = 512):
        super().__init__()
        self.num_inputs, self.in_features = num_inputs, in_features
        self.out_features = out_features
        self.relate = nn.Sequential(
            nn.ReLU(), linear(num_inputs * in_features, bottleneck_dim),
            nn.ReLU(), linear(bottleneck_dim, out_features))

    def forward(self, x):
        h = self.relate(x.reshape(-1, self.num_inputs * self.in_features))
        return h.reshape(x.shape[0], -1, self.out_features)


class MultiScaleRelation(nn.Module):
    """Sum of ``num_relations`` m-frame relations for m = n..2
    (trn.py:59-113)."""

    def __init__(self, num_inputs: int, in_features: int, out_features: int,
                 bottleneck_dim: int = 512, num_relations: int = 3):
        super().__init__()
        self.num_inputs, self.out_features = num_inputs, out_features
        self.num_relations = num_relations
        self.scales = list(range(num_inputs, 1, -1))
        self.relations = nn.ModuleList(
            Relation(scale, in_features, out_features, bottleneck_dim)
            for scale in self.scales)

    def combinations(self, scale: int,
                     generator: Optional[torch.Generator] = None):
        """The (k, scale) frame indices related at ``scale``: the first k
        ordered combinations, or k distinct ones drawn from ``generator``."""
        combos = torch.tensor(list(itertools.combinations(
            range(self.num_inputs), scale)))              # (m, scale)
        k = min(self.num_relations, len(combos))
        if generator is None:
            return combos[:k]
        idx = torch.randperm(len(combos), generator=generator,
                             device=generator.device)[:k]
        return combos[idx.cpu()]

    def forward(self, x, generator: Optional[torch.Generator] = None):
        total = None
        for scale, rel in zip(self.scales, self.relations):
            sel = self.combinations(scale, generator)
            gathered = x.index_select(-2, sel.reshape(-1).to(x.device))
            gathered = gathered.reshape(x.shape[:-2] + tuple(sel.shape)
                                        + (x.shape[-1],))
            out = rel(gathered).sum(dim=1, keepdim=True)  # over the combos
            total = out if total is None else total + out
        return total.reshape(x.shape[0], -1, self.out_features)


class HierarchicalRelation(nn.Module):
    """Recursive neighbourhood relations (trn.py:116-159): each level
    relates every window of ``relation_size`` neighbours (one shared
    ``Relation``), its linear summed over the windows; the last level's
    windows go through ``final_relation``; the mean over levels."""

    def __init__(self, num_inputs: int, in_features: int, out_features: int,
                 relation_size: int = 4, relation_dist: int = 1,
                 bottleneck_dim: int = 1024):
        super().__init__()
        self.num_inputs, self.in_features = num_inputs, in_features
        self.relation_size = relation_size
        depth = math.ceil((num_inputs - relation_size) / (relation_size - 1))
        num_final = num_inputs + depth * (1 - relation_size)
        self.relations = nn.ModuleList(
            Relation(relation_size, in_features, in_features)
            for _ in range(depth))
        self.linears = nn.ModuleList(linear(in_features, out_features)
                                     for _ in range(depth))
        self.final_relation = Relation(num_final, in_features, out_features)

    def forward(self, x):
        x = x.reshape(-1, self.num_inputs, self.in_features)
        outs = []
        for rel, lin in zip(self.relations, self.linears):
            # (B, n, F) -> the windows (B, n - size + 1, size, F)
            windows = x.unfold(1, self.relation_size, 1).transpose(-1, -2)
            x = rel(windows)
            outs.append(lin(x).sum(dim=-2))
        outs.append(self.final_relation(x)[:, 0])
        return torch.stack(outs).mean(dim=0)


class MultiScaleHierarchicalRelation(nn.Module):
    """A ``HierarchicalRelation`` for every relation size n..2, related by
    ``final_relation`` (trn.py:162-189)."""

    def __init__(self, num_inputs: int, in_features: int, out_features: int,
                 relation_dist: int = 1, bottleneck_dim: int = 512):
        super().__init__()
        self.num_inputs, self.in_features = num_inputs, in_features
        self.out_features = out_features
        scales = list(range(num_inputs, 1, -1))
        self.h_relations = nn.ModuleList(
            HierarchicalRelation(num_inputs, in_features, out_features,
                                 relation_size=scale,
                                 relation_dist=relation_dist,
                                 bottleneck_dim=bottleneck_dim)
            for scale in scales)
        self.final_relation = Relation(len(scales), out_features,
                                       out_features, bottleneck_dim)

    def forward(self, x):
        x = x.reshape(-1, self.num_inputs, self.in_features)
        h = torch.stack([r(x).reshape(-1, self.out_features)
                         for r in self.h_relations], dim=1)
        return self.final_relation(h)[:, 0]


_CONSENSUS = {
    'TRN': Relation,
    'HTRN': HierarchicalRelation,
    'MSTRN': MultiScaleRelation,
    'MSHTRN': MultiScaleHierarchicalRelation,
}


class TRN(PretrainedModel):
    """Per-frame 2D backbone + temporal relation head (trn.py:192-343)."""

    def __init__(self, base_module: PretrainedModel, frame_feature_dim: int,
                 num_classes: int, num_segments: int = 8,
                 consensus: str = 'MSTRN', video_feature_dim: int = 1024,
                 frame_bottleneck_dim: int = 1024, dropout_rate: float = 0.5):
        if consensus not in _CONSENSUS:
            raise ValueError(f'consensus {consensus!r} is none of '
                             f'{sorted(_CONSENSUS)}')
        super().__init__(num_classes, video_feature_dim)
        base_module.last_linear = Identity()  # the reference's Dropout head
        self.base_module = base_module
        self.num_segments, self.consensus = num_segments, consensus
        self.dropout_rate = dropout_rate
        self.temporal_relation = _CONSENSUS[consensus](
            num_inputs=num_segments, in_features=frame_feature_dim,
            out_features=video_feature_dim,
            bottleneck_dim=frame_bottleneck_dim)
        self.last_linear = linear(video_feature_dim, num_classes)

    def _features(self, x, generator: Optional[torch.Generator] = None):
        b, c, t = x.shape[:3]
        frames = x.transpose(1, 2).reshape(b * t, c, *x.shape[3:])
        base = self.base_module
        feats = base._logits(base._features(frames))    # pooled, no head
        feats = F.dropout(feats, self.dropout_rate, self.training)
        feats = feats.reshape(b, -1, self.num_segments, feats.shape[-1])
        if self.consensus == 'MSTRN':
            x = self.temporal_relation(feats, generator)
        else:
            x = self.temporal_relation(feats)
        return x.reshape(b, -1)

    def _logits(self, features):
        return self.last_linear(features)

    def features(self, x, generator: Optional[torch.Generator] = None):
        """The relation head's output; ``generator`` draws MSTRN's
        combinations (the first ones without it)."""
        with self._autocast(x):
            return self._features(x, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        with self._autocast(x):
            return self._logits(self._features(x, generator))


def get_optim_policy_groups():
    """LR / decay multiplier groups mirroring trn.py:287-330."""
    return [
        {'match': 'first_conv_weight', 'lr_mult': 1, 'decay_mult': 1},
        {'match': 'first_conv_bias', 'lr_mult': 2, 'decay_mult': 0},
        {'match': 'normal_weight', 'lr_mult': 1, 'decay_mult': 1},
        {'match': 'normal_bias', 'lr_mult': 2, 'decay_mult': 0},
        {'match': 'bn', 'lr_mult': 1, 'decay_mult': 0},
    ]


@register_model
def trn(num_classes: int = 339, num_segments: int = 8, consensus: str = 'MSTRN',
        arch: str = 'resnet50', pretrained=None,
        frame_bottleneck_dim: int = 1024, video_feature_dim: int = 1024):
    """TRN over a 2D backbone from this registry. The relation head and
    ``last_linear`` start from seed 0; the backbone keeps its factory's
    weights (hosted ones for ``pretrained`` 'imagenet' or 'moments')."""
    from ..core.registry import MODEL_REGISTRY

    num_pc = 1000 if pretrained == 'imagenet' else 339
    base_pretrained = pretrained if pretrained in ('imagenet', 'moments') else None
    base = MODEL_REGISTRY[arch](num_classes=num_pc, pretrained=base_pretrained)
    model = TRN(base, base.num_features, num_classes,
                num_segments=num_segments, consensus=consensus,
                video_feature_dim=video_feature_dim,
                frame_bottleneck_dim=frame_bottleneck_dim)
    g = torch.Generator().manual_seed(0)
    init_parameters(model.temporal_relation, g)
    init_parameters(model.last_linear, g)
    model.name = 'trn'
    model.settings = dict(pretrained_settings['trn'].get(pretrained, {})) or None
    # TRN inherits preprocessing metadata from its backbone (trn.py:213-216)
    model.stamp_metadata(model.settings or {
        attr: getattr(base, attr) for attr in
        ('input_space', 'input_size', 'input_range', 'mean', 'std')})
    model.input_ndim = 5
    return model


register_settings(pretrained_settings, in_settings_registry=False)
