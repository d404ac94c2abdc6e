"""Dataset helpers and the multilabel AP meter.

Counterpart of ``pretorched_tpu/datasets/utils.py`` (reference:
datasets/utils.py): ``load_imagenet_classes`` (:9-29), ``Warp`` (:32-42),
``download_url`` (:45-83) and ``AveragePrecisionMeter`` (:86-199). The
meter takes tensors (on any device) or arrays and computes in numpy on
the host, as the JAX package does; its ranking is a stable sort, so tied
scores keep their order of arrival.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
from PIL import Image

from ..utils.misc import host_array


def load_imagenet_classes(path_synsets: str = 'data/imagenet_synsets.txt',
                          path_classes: str = 'data/imagenet_classes.txt'
                          ) -> List[str]:
    """Class id -> human-readable name, from the synset list and the
    ordered class keys."""
    with open(path_synsets) as f:
        splits = [line.strip().split(' ') for line in f if line.strip()]
    key_to_classname = {s[0]: ' '.join(s[1:]) for s in splits}
    with open(path_classes) as f:
        keys = [line.strip() for line in f if line.strip()]
    return [key_to_classname[k] for k in keys]


class Warp:
    """Square resize that ignores the aspect ratio (reference:
    utils.py:32-42)."""

    def __init__(self, size: int, interpolation=Image.BILINEAR):
        self.size = int(size)
        self.interpolation = interpolation

    def __call__(self, img: Image.Image) -> Image.Image:
        return img.resize((self.size, self.size), self.interpolation)

    def __str__(self):
        return (f'{type(self).__name__} (size={self.size}, '
                f'interpolation={self.interpolation})')


def download_url(url: str, destination: Optional[str] = None,
                 progress_bar: bool = True) -> Optional[str]:
    """Download a URL to a local file (reference: utils.py:45-83).

    Returns ``destination`` at once when the file already exists. Uses
    tqdm for the progress bar when it is installed."""
    if destination is not None and os.path.exists(destination):
        return destination
    from urllib.request import urlretrieve
    hook = None
    if progress_bar:
        try:
            from tqdm import tqdm

            t = tqdm(unit='B', unit_scale=True, miniters=1,
                     desc=url.split('/')[-1])
            last = [0]

            def hook(b=1, bsize=1, tsize=None):  # noqa: F811
                if tsize is not None:
                    t.total = tsize
                if b > 0:
                    t.update((b - last[0]) * bsize)
                last[0] = b
        except ImportError:
            pass
    try:
        filename, _ = urlretrieve(url, filename=destination, reporthook=hook)
    finally:
        if progress_bar and hook is not None:
            t.close()
    return filename


class AveragePrecisionMeter:
    """Per-class average precision over streamed (scores, targets) batches
    (reference: datasets/utils.py:86-199). VOC targets: 1 positive, -1
    negative, 0 difficult; difficult rows are skipped when
    ``difficult_examples`` is True (else counted as negatives)."""

    def __init__(self, difficult_examples: bool = False):
        self.difficult_examples = difficult_examples
        self.reset()

    def reset(self):
        self._scores: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def add(self, output, target):
        output = host_array(output).astype(np.float32)
        target = host_array(target)
        if output.ndim == 1:
            output = output[:, None]
        if target.ndim == 1:
            target = target[:, None]
        if output.ndim != 2 or target.shape != output.shape:
            raise ValueError(f'scores {output.shape} and targets '
                             f'{target.shape} must be the same (N, K)')
        if self._scores and output.shape[1] != self._scores[0].shape[1]:
            raise ValueError('dimensions for output should match previously '
                             'added examples.')
        self._scores.append(output)
        self._targets.append(target)

    def value(self) -> np.ndarray:
        if not self._scores:
            return np.zeros(0, np.float32)
        scores = np.concatenate(self._scores, 0)
        targets = np.concatenate(self._targets, 0)
        k = scores.shape[1]
        ap = np.zeros(k, np.float32)
        for c in range(k):
            ap[c] = self.average_precision(scores[:, c], targets[:, c],
                                           self.difficult_examples)
        return ap

    @staticmethod
    def average_precision(output, target,
                          difficult_examples: bool = True) -> float:
        order = np.argsort(-host_array(output), kind='stable')
        labels = host_array(target)[order]
        if difficult_examples:
            labels = labels[labels != 0]
        pos = labels == 1
        pos_count = np.cumsum(pos)
        total_count = np.arange(1, labels.size + 1)
        n_pos = pos_count[-1] if labels.size else 0
        if n_pos == 0:
            return 0.0
        return float((pos_count / total_count)[pos].sum() / n_pos)
