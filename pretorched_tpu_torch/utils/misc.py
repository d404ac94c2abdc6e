"""Misc utilities and the metric meters of the example CLIs.

Counterpart of ``pretorched_tpu/utils/misc.py`` (reference:
pretorched/utils.py:9-167, imagenet_eval.py:262-301): memoizing
decorators, an HTML report builder for (video) predictions, softmax and
log-add, confusion-matrix class accuracy, chunking, sorting and top-k
accuracy, each returning what the JAX helper returns for the same input
(tensors are brought to the host first), plus the meters.
``DeviceRunningSums`` keeps per-step metric sums on the device, so an eval
loop synchronizes with the card once per printed line, not once per step.
"""

from __future__ import annotations

from operator import itemgetter
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class cache:
    """Compute an attribute value once and cache it on the instance
    (reference: utils.py:9-27)."""

    def __init__(self, method, name=None):
        self.method = method
        self.name = name or method.__name__
        self.__doc__ = method.__doc__

    def __get__(self, obj, cls):
        if obj is None:
            return self
        value = self.method(obj)
        setattr(obj, self.name, value)
        return value


def lazy_property(fn):
    """Lazy-evaluated property (reference: utils.py:30-39)."""
    attr_name = '_' + fn.__name__

    @property
    def _lazy_property(self):
        if not hasattr(self, attr_name):
            setattr(self, attr_name, fn(self))
        return getattr(self, attr_name)
    return _lazy_property


class HTML:
    """Minimal HTML report builder for (video) prediction galleries
    (reference capability: utils.py:42-126)."""

    @staticmethod
    def head(title: str = 'predictions') -> str:
        return ('<!DOCTYPE html><html><head>'
                f'<meta charset="utf-8"><title>{title}</title>'
                '<style>body{font-family:sans-serif}'
                '.item{display:inline-block;margin:8px;text-align:center}'
                'img,video{max-width:320px}</style></head><body>')

    @staticmethod
    def element(elem: str, inner: str = '', id_: str = '', cls_: str = '',
                attr: str = '') -> str:
        parts = [elem]
        if id_:
            parts.append(f'id="{id_}"')
        if cls_:
            parts.append(f'class="{cls_}"')
        if attr:
            parts.append(attr)
        return f'<{" ".join(parts)}>{inner}</{elem}>'

    @staticmethod
    def media_item(src: str, caption: str) -> str:
        media = (f'<video controls src="{src}"></video>'
                 if src.endswith(('.mp4', '.webm')) else f'<img src="{src}"/>')
        return f'<div class="item">{media}<div>{caption}</div></div>'

    @staticmethod
    def page(items: Iterable[Tuple[str, str]],
             title: str = 'predictions') -> str:
        body = ''.join(HTML.media_item(src, cap) for src, cap in items)
        return HTML.head(title) + body + '</body></html>'


def softmax(scores) -> np.ndarray:
    """Numerically stable softmax over the last axis (reference:
    utils.py:141-143)."""
    scores = host_array(scores)
    es = np.exp(scores - scores.max(axis=-1)[..., None])
    return es / es.sum(axis=-1)[..., None]


def log_add(log_a, log_b):
    """log(exp(a) + exp(b)) (reference: utils.py:146-147)."""
    return log_a + np.log(1 + np.exp(log_b - log_a))


def class_accuracy(prediction: Sequence[int], label: Sequence[int]):
    """Per-class and mean class accuracy from the confusion matrix
    (reference: utils.py:150-156)."""
    from sklearn.metrics import confusion_matrix

    cf = confusion_matrix(host_array(prediction), host_array(label))
    cls_cnt = cf.sum(axis=1)
    cls_hit = np.diag(cf)
    cls_acc = cls_hit / np.maximum(cls_cnt, 1).astype(float)
    return cls_acc, cls_acc.mean()


def chunks(l, n):  # noqa: E741
    """Yield successive n-sized chunks (reference: utils.py:159-162)."""
    for i in range(0, len(l), n):
        yield l[i:i + n]


def sort(arr):
    """(indices, sorted values) (reference: utils.py:165-167)."""
    return zip(*sorted(enumerate(arr), key=itemgetter(1)))


def topk_accuracy(output, target, topk=(1,)) -> List[float]:
    """Top-k accuracy in percent (reference: imagenet_eval.py:288-301)."""
    output = host_array(output)
    target = host_array(target)
    maxk = max(topk)
    pred = np.argsort(-output, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


class AverageMeter:
    """Running average meter used by the CLIs (reference: imagenet_eval.py:262-278)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class DeviceRunningSums:
    """Accumulates a dict of per-step device scalars without host syncs.

    ``update`` adds the step's scalars into running sums that stay on the
    device (asynchronous, like the step itself); ``snapshot()`` and
    ``totals()`` bring them to the host with ONE transfer each: call them
    only where a line is printed and at the end of the loop."""

    def __init__(self):
        self.last = None       # the most recent step's dict of tensors
        self.sums = None       # running sums, on the device

    def __bool__(self):
        return self.sums is not None

    def update(self, out: dict):
        self.last = out
        self.sums = (dict(out) if self.sums is None
                     else {k: self.sums[k] + out[k] for k in self.sums})

    @staticmethod
    def _to_host(*dicts):
        keys = [list(d) for d in dicts]
        flat = torch.stack([d[k].to(torch.float64)
                            for d, ks in zip(dicts, keys) for k in ks])
        values = iter(flat.tolist())          # the one device -> host copy
        return [{k: next(values) for k in ks} for ks in keys]

    def snapshot(self):
        """One host sync: returns (last_step_dict, totals_dict) as floats."""
        last, sums = self._to_host(self.last, self.sums)
        return last, sums

    def totals(self):
        """One host sync: the running totals as floats."""
        return self._to_host(self.sums)[0]
