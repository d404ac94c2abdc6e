"""ImageFolder-style dataset, threaded batch loader and the fast eval
pipeline.

Counterpart of ``pretorched_tpu/datasets/folder.py``: a class per
subdirectory, a transform per sample, and a threaded loader that emits
stacked numpy batches (``batch_iterator``). Its shuffle draws from
``np.random.RandomState(seed)`` and its shards are equal strided slices, as
in the JAX package, so both packages visit the same images in the same
order. ``fast_eval_batches`` decodes JPEGs at a reduced DCT scale on host
threads and runs ``fused_preprocess`` on the device.
"""

from __future__ import annotations

import math
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.webp')


def _prefetched(items: Iterator, prefetch: int, cleanup=None) -> Iterator:
    """Drain ``items`` on a producer thread through a bounded queue.

    The consumer sees up to ``prefetch`` items buffered ahead. A producer
    exception is re-raised to the consumer after the buffered items drain
    (the stop sentinel is always enqueued, so the consumer never hangs); an
    early consumer exit unblocks and ends the producer."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    stop = object()
    abandoned = threading.Event()
    error = []

    def put_or_abandon(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for item in items:
                if not put_or_abandon(item):
                    return
        except BaseException as e:  # re-raised in the consumer below
            error.append(e)
        finally:
            put_or_abandon(stop)
            if cleanup is not None:
                cleanup()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        if error:
            raise error[0]
    finally:
        abandoned.set()


class ImageFolder:
    """A class per subdirectory; items are (transformed image, label)."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, fname),
                                             self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        with open(path, 'rb') as f:
            img = Image.open(f).convert('RGB')
        if self.transform is not None:
            img = self.transform(img)
        return img, label


def batch_iterator(dataset, batch_size: int, shuffle: bool = False,
                   num_workers: int = 8, drop_last: bool = False,
                   seed: int = 0, prefetch: int = 2,
                   shard_id: int = 0, num_shards: int = 1
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Threaded loader yielding (stacked images, int64 labels) numpy
    batches.

    Every shard shuffles the same global order from ``seed``, the order is
    cut to a multiple of ``num_shards``, and shard ``shard_id`` takes a
    strided slice of it: the shards are disjoint and yield the same number
    of batches."""
    if not 0 <= shard_id < num_shards:
        raise ValueError(f'shard {shard_id} of {num_shards}')
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    if num_shards > 1:
        order = order[:len(order) - len(order) % num_shards]
        order = order[shard_id::num_shards]
    batches = [order[i:i + batch_size]
               for i in range(0, len(order), batch_size)]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()

    executor = ThreadPoolExecutor(max_workers=max(num_workers, 1))

    def load_batch(idxs):
        items = list(executor.map(dataset.__getitem__, idxs))
        imgs = np.stack([np.asarray(x) for x, _ in items])
        labels = np.asarray([y for _, y in items], np.int64)
        return imgs, labels

    yield from _prefetched((load_batch(idxs) for idxs in batches), prefetch,
                           cleanup=lambda: executor.shutdown(wait=False))


def fast_eval_batches(root: str, settings, batch_size: int,
                      num_threads: int = 8, channels_last: bool = True,
                      prefetch: int = 2, dtype: torch.dtype = torch.float32,
                      device='cuda'):
    """The fast eval pipeline: threaded JPEG decode at a reduced DCT scale
    (``datasets.native``), then ``fused_preprocess`` on ``device``. Yields
    (normalized batch on ``device``, numpy labels), one batch per decoded
    size within each chunk of ``batch_size`` files, so a batch may be
    smaller than ``batch_size``.

    The decode scale is the largest of 1/8, 1/4, 1/2 that keeps every
    image's short side, read from the headers, at or above the resize
    target. A producer thread decodes and queues the device work of up to
    ``prefetch`` batches ahead of the consumer."""
    from ..transforms.fused import _settings_tuple, fused_preprocess
    from .native import decode_jpeg_batch, jpeg_short_side

    ds = ImageFolder(root)
    (input_size, _, _, _, _, scale) = _settings_tuple(settings)
    target_short = int(math.floor(max(input_size) / scale))

    def decoded_batches():
        for i in range(0, len(ds.samples), batch_size):
            chunk = ds.samples[i:i + batch_size]
            buffers, labels = [], []
            for path, label in chunk:
                with open(path, 'rb') as f:
                    buffers.append(f.read())
                labels.append(label)
            shorts = [jpeg_short_side(b) for b in buffers]
            denom = 1
            if shorts and all(s is not None for s in shorts):
                smallest = min(shorts)
                denom = next((d for d in (8, 4, 2)
                              if smallest // d >= target_short), 1)
            arrays = decode_jpeg_batch(buffers, threads=num_threads,
                                       scale_denom=denom)
            by_size = {}
            for arr, label in zip(arrays, labels):
                by_size.setdefault(arr.shape, []).append((arr, label))
            for items in by_size.values():
                imgs = np.stack([a for a, _ in items])
                lbls = np.asarray([lab for _, lab in items], np.int64)
                yield (fused_preprocess(imgs, settings,
                                        channels_last=channels_last,
                                        dtype=dtype, device=device), lbls)

    yield from _prefetched(decoded_batches(), prefetch)
