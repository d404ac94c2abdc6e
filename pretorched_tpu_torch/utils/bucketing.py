"""Shape bucketing for variable input sizes.

Counterpart of ``pretorched_tpu/utils/bucketing.py``. There, each new input
shape compiles a new XLA program, so shapes snap to a small ladder. The
port compiles nothing, but the same buckets keep a CLI's batches
fixed-shape (one accumulator per bucket) and its numbers equal to the JAX
package's:

* ``bucket_dim / bucket_spatial / bucket_frames``: shape math;
* ``resize_to_bucket``: bilinear resize of a channels-last image batch up
  to its bucket (resizing, not zero-padding: the global pools would count
  the padding), with the weights of ``jax.image.resize``
  (``transforms.fused.resize_weights``), so the two agree edges included;
* ``resample_frames_to_bucket``: nearest-frame re-sampling of a clip's
  time axis up to its frame bucket (an index selection, so exact);
* ``BucketedModel``: a model whose input is canonicalized first.

A shape already on the ladder passes through untouched (the same object).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..transforms.fused import resize_weights


def bucket_dim(n: int, multiple: int = 32,
               ladder: Optional[Sequence[int]] = None) -> int:
    """Round ``n`` up to the next rung: the smallest ladder entry >= n, or
    the next multiple of ``multiple``. Above every ladder rung it falls
    back to the multiple rule (never a downsize) and warns."""
    if ladder is not None:
        for rung in sorted(ladder):
            if rung >= n:
                return rung
        warnings.warn(
            f'bucket_dim: {n} exceeds every ladder rung {sorted(ladder)}; '
            f'rounding up to a multiple of {multiple} instead (unbounded '
            f'compile set for such sizes)', stacklevel=2)
    return ((n + multiple - 1) // multiple) * multiple


def bucket_spatial(h: int, w: int, multiple: int = 32) -> Tuple[int, int]:
    return bucket_dim(h, multiple), bucket_dim(w, multiple)


def bucket_frames(t: int, multiple: int = 8) -> int:
    return bucket_dim(t, multiple)


def _resize(x: torch.Tensor, hb: int, wb: int, channels_last: bool):
    """Bilinear resize of the spatial dims ((..., H, W, C) or (..., H, W))
    to (hb, wb), in ``x``'s dtype (float), with JAX's triangle weights."""
    h, w = x.shape[-3:-1] if channels_last else x.shape[-2:]
    wh = resize_weights(h, hb, hb / h, 0.0, x.device).to(x.dtype)
    ww = resize_weights(w, wb, wb / w, 0.0, x.device).to(x.dtype)
    if channels_last:
        return torch.einsum('oh,pw,...hwc->...opc', wh, ww, x)
    return wh @ x @ ww.T


def resize_to_bucket(x: torch.Tensor, multiple: int = 32):
    """Resize a channels-last image batch (..., H, W, C) up to its spatial
    bucket. No-op when already on the ladder."""
    h, w = x.shape[-3], x.shape[-2]
    hb, wb = bucket_spatial(h, w, multiple)
    if (hb, wb) == (h, w):
        return x
    return _resize(x, hb, wb, channels_last=True)


def frame_indices(t: int, tb: int) -> np.ndarray:
    """The ``tb`` source frames of a ``t``-frame clip: ``round(linspace(0,
    t - 1, tb))`` rounded half to even and clipped, as the JAX package's
    ``resample_frames_to_bucket`` picks them. The positions are computed
    in float32 in the order XLA evaluates ``jnp.linspace``:
    ``i * ((t - 1) * (1 / (tb - 1)))``, the last one exactly ``t - 1``, so
    a position that lies half-way between two frames rounds the same way."""
    if tb == 1:
        return np.zeros(1, np.int64)
    step = np.float32(t - 1) * (np.float32(1) / np.float32(tb - 1))
    pos = np.arange(tb, dtype=np.float32) * step
    pos[-1] = np.float32(t - 1)
    return np.clip(np.round(pos).astype(np.int64), 0, t - 1)


def resample_frames_to_bucket(clip: torch.Tensor, multiple: int = 8,
                              time_axis: int = 1):
    """Re-sample a clip's time axis up to its frame bucket by repeating the
    nearest frames (the usual short-video protocol)."""
    t = clip.shape[time_axis]
    tb = bucket_frames(t, multiple)
    if tb == t:
        return clip
    idx = torch.from_numpy(frame_indices(t, tb)).to(clip.device)
    return clip.index_select(time_axis, idx)


class BucketedModel:
    """Shape-canonicalizing front for a port model (channels-first input).

    ``BucketedModel(model)(x)`` re-samples T of a 5-D clip (N, C, T, H, W)
    to its frame bucket and resizes H and W to their spatial bucket (or to
    the ``ladder``'s rungs) before the forward; every other attribute is
    the model's."""

    def __init__(self, model, spatial_multiple: int = 32,
                 frame_multiple: int = 8,
                 ladder: Optional[Sequence[int]] = None):
        self.model = model
        self.spatial_multiple = spatial_multiple
        self.frame_multiple = frame_multiple
        self.ladder = ladder

    def _canonicalize(self, x):
        x = torch.as_tensor(x)
        if x.dim() == 5:
            x = resample_frames_to_bucket(x, self.frame_multiple, time_axis=2)
        h, w = x.shape[-2:]
        if self.ladder is not None:
            hb = bucket_dim(h, ladder=self.ladder)
            wb = bucket_dim(w, ladder=self.ladder)
        else:
            hb, wb = bucket_spatial(h, w, self.spatial_multiple)
        if (hb, wb) != (h, w):
            x = _resize(x, hb, wb, channels_last=False)
        return x

    def forward(self, x):
        return self.model(self._canonicalize(x))

    __call__ = forward

    def features(self, x):
        return self.model.features(self._canonicalize(x))

    def __getattr__(self, name):
        return getattr(self.model, name)
