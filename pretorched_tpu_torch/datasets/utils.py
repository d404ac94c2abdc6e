"""Dataset helpers.

Counterpart of ``load_imagenet_classes`` in
``pretorched_tpu/datasets/utils.py`` (reference: datasets/utils.py:9-29).
"""

from __future__ import annotations

from typing import List


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
