"""Preprocessing transforms: the PIL oracle path.

Counterpart of ``pretorched_tpu/transforms/utils.py`` (reference:
pretorched/transforms/utils.py:34-114). The transform is derived from the
model's own ``input_size / input_space / input_range / mean / std``
metadata. Resizing and cropping run on PIL images (bilinear, torchvision's
``Resize`` and ``CenterCrop`` rules), then the image becomes a float32 CHW
``torch.Tensor``, as the reference's torchvision chain returns.

This path is the numerics oracle; ``transforms.fused`` is the device path.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from PIL import Image

__all__ = ['ToSpaceBGR', 'ToRange255', 'TransformImage', 'LoadImage',
           'LoadTransformImage', 'Identity', 'Compose']


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToSpaceBGR:
    """Flip RGB -> BGR channel order of a CHW tensor (reference:
    utils.py:9-20)."""

    def __init__(self, is_bgr: bool):
        self.is_bgr = is_bgr

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t.flip(0) if self.is_bgr else t


class ToRange255:
    """Rescale [0, 1] -> [0, 255] when the model expects it
    (utils.py:23-31)."""

    def __init__(self, is_255: bool):
        self.is_255 = is_255

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t * 255.0 if self.is_255 else t


class _Resize:
    """torchvision ``Resize``: an int sets the shorter side, a pair the
    exact (h, w)."""

    def __init__(self, size: Union[int, Sequence[int]]):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        if isinstance(self.size, int):
            w, h = img.size
            short, long = (w, h) if w <= h else (h, w)
            if short == self.size:
                return img
            new_short = self.size
            new_long = int(round(self.size * long / short))
            nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
            return img.resize((nw, nh), Image.BILINEAR)
        h, w = self.size
        return img.resize((w, h), Image.BILINEAR)


class _CenterCrop:
    def __init__(self, size: int):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img: Image.Image) -> Image.Image:
        th, tw = self.size
        w, h = img.size
        if w < tw or h < th:  # torchvision pads smaller images with zeros
            padded = Image.new(img.mode, (max(w, tw), max(h, th)))
            padded.paste(img, ((max(w, tw) - w) // 2, (max(h, th) - h) // 2))
            img, (w, h) = padded, padded.size
        left = int(round((w - tw) / 2.0))
        top = int(round((h - th) / 2.0))
        return img.crop((left, top, left + tw, top + th))


class _RandomCrop:
    def __init__(self, size: int, rng: np.random.Generator):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.rng = rng

    def __call__(self, img: Image.Image) -> Image.Image:
        th, tw = self.size
        w, h = img.size
        if w == tw and h == th:
            return img
        left = int(self.rng.integers(0, max(w - tw, 0) + 1))
        top = int(self.rng.integers(0, max(h - th, 0) + 1))
        return img.crop((left, top, left + tw, top + th))


class _RandomFlip:
    def __init__(self, method, rng: np.random.Generator):
        self.method = method
        self.rng = rng

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.rng.random() < 0.5:
            return img.transpose(self.method)
        return img


class _ToTensor:
    """HWC uint8 PIL -> CHW float32 tensor in [0, 1] (torchvision
    ``ToTensor``)."""

    def __call__(self, img: Image.Image) -> torch.Tensor:
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))


class _Normalize:
    def __init__(self, mean, std):
        self.mean = torch.tensor(mean, dtype=torch.float32).reshape(-1, 1, 1)
        self.std = torch.tensor(std, dtype=torch.float32).reshape(-1, 1, 1)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return (t - self.mean) / self.std


class TransformImage:
    """The eval (or train) transform built from model metadata (reference:
    transforms/utils.py:34-81).

    ``opts`` is a model (attribute access) or a settings dict. ``scale``
    defaults to the model's own ``scale`` metadata when present
    (xception.py:44), else 0.875."""

    def __init__(self, opts, scale: Optional[float] = None, random_crop=False,
                 random_hflip=False, random_vflip=False,
                 preserve_aspect_ratio=True, seed: Optional[int] = None,
                 crop: bool = True):
        if isinstance(opts, dict):
            get = opts.__getitem__
            has = opts.__contains__
        else:
            def get(k):
                return getattr(opts, k)

            def has(k):
                return hasattr(opts, k)
        self.input_size = list(get('input_size'))
        self.input_space = get('input_space')
        self.input_range = list(get('input_range'))
        self.mean = list(get('mean'))
        self.std = list(get('std'))
        self.scale = scale if scale is not None else (
            get('scale') if has('scale') else 0.875)
        self.random_crop = random_crop
        self.random_hflip = random_hflip
        self.random_vflip = random_vflip
        rng = np.random.default_rng(seed)

        crop_size = max(self.input_size)
        tfs = []
        if preserve_aspect_ratio:
            tfs.append(_Resize(int(math.floor(crop_size / self.scale))))
        else:
            height = int(self.input_size[1] / self.scale)
            width = int(self.input_size[2] / self.scale)
            tfs.append(_Resize((height, width)))
        if random_crop:
            tfs.append(_RandomCrop(crop_size, rng))
        elif crop:
            tfs.append(_CenterCrop(crop_size))
        # crop=False: resize only (a 10-crop eval crops later)
        if random_hflip:
            tfs.append(_RandomFlip(Image.FLIP_LEFT_RIGHT, rng))
        if random_vflip:
            tfs.append(_RandomFlip(Image.FLIP_TOP_BOTTOM, rng))
        tfs.append(_ToTensor())
        tfs.append(ToSpaceBGR(self.input_space == 'BGR'))
        tfs.append(ToRange255(max(self.input_range) == 255))
        tfs.append(_Normalize(self.mean, self.std))
        self.tf = Compose(tfs)

    def __call__(self, img: Image.Image) -> torch.Tensor:
        return self.tf(img)


class LoadImage:
    """Open an image file as PIL (reference: utils.py:84-93)."""

    def __init__(self, space: str = 'RGB'):
        self.space = space

    def __call__(self, path_img) -> Image.Image:
        with open(path_img, 'rb') as f:
            with Image.open(f) as img:
                return img.convert(self.space)


class LoadTransformImage:
    """Load and transform in one call (reference: utils.py:96-105)."""

    def __init__(self, model, scale: Optional[float] = None):
        self.load = LoadImage()
        self.tf = TransformImage(model, scale=scale)

    def __call__(self, path_img) -> torch.Tensor:
        return self.tf(self.load(path_img))


class Identity:
    """Pass-through transform (reference: utils.py:108-114)."""

    def __call__(self, x):
        return x
