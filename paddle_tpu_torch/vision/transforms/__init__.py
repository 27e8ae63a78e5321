"""Vision transforms for a classification pipeline (numpy, host-side).
Counterpart of the JAX package's ``paddle_tpu/vision/transforms``:
``Compose``, ``BaseTransform``, ``ToTensor``, ``Normalize``, ``Resize``,
``CenterCrop``, ``RandomCrop``, ``RandomHorizontalFlip``,
``RandomVerticalFlip``, ``RandomResizedCrop``, ``Transpose``, ``Pad`` and
the functional forms ``to_tensor`` ... ``pad``, with the same arithmetic.

Images are HWC numpy arrays (a 2-D array is one channel). ``ToTensor``
gives a CPU ``torch.Tensor`` (CHW float32 in [0, 1]); ``io.DataLoader``
moves the batch to its device. The random transforms draw from
``generator`` (a ``random.Random``) when given one, else from python's
``random`` module as the JAX package's do, so ``random.seed(s)`` there
and ``generator=random.Random(s)`` here draw the same crops and flips.
The colour, affine, perspective and erasing transforms are port queue
item 9.
"""
from __future__ import annotations

import numbers
import random

import numpy as np
import torch

__all__ = ["BaseTransform", "CenterCrop", "Compose", "Normalize", "Pad",
           "RandomCrop", "RandomHorizontalFlip", "RandomResizedCrop",
           "RandomVerticalFlip", "Resize", "ToTensor", "Transpose",
           "center_crop", "crop", "hflip", "normalize", "pad", "resize",
           "to_tensor", "vflip"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


def _hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _rng(t):
    return t.generator or random


def _size(size):
    return (size, size) if isinstance(size, numbers.Number) else tuple(size)


class ToTensor(BaseTransform):
    """HWC (uint8 or float) -> a CPU float32 tensor, CHW by default,
    scaled to [0, 1] when its values exceed 1.5."""

    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _hwc(img).astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if self.data_format == "CHW":
            arr = np.transpose(arr, (2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(arr))


class Normalize(BaseTransform):
    """``(img - mean) / std`` per channel; a tensor stays a tensor."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        is_tensor = isinstance(img, torch.Tensor)
        arr = (img.numpy() if is_tensor
               else np.asarray(img, dtype=np.float32))
        if self.data_format == "CHW":
            m, s = self.mean.reshape(-1, 1, 1), self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        out = (arr - m) / s
        return torch.from_numpy(np.ascontiguousarray(out)) if is_tensor \
            else out


class Resize(BaseTransform):
    """Nearest-neighbour resize to ``size`` (the JAX package's sampling:
    rows and columns at ``linspace(0, n - 1, size)``, truncated)."""

    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = _hwc(img)
        h, w = self.size
        ih, iw = arr.shape[:2]
        ys = (np.linspace(0, ih - 1, h)).astype(np.int64)
        xs = (np.linspace(0, iw - 1, w)).astype(np.int64)
        return arr[ys][:, xs]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = _size(size)

    def _apply_image(self, img):
        arr = _hwc(img)
        th, tw = self.size
        h, w = arr.shape[:2]
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None, generator=None):
        self.size = _size(size)
        self.padding = padding
        self.generator = generator

    def _apply_image(self, img):
        arr = _hwc(img)
        if self.padding:
            p = (self.padding if isinstance(self.padding, (list, tuple))
                 else [self.padding] * 4)
            arr = np.pad(arr, ((p[1], p[3]), (p[0], p[2]), (0, 0)))
        th, tw = self.size
        h, w = arr.shape[:2]
        i = _rng(self).randint(0, max(h - th, 0))
        j = _rng(self).randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        self.prob = prob
        self.generator = generator

    def _apply_image(self, img):
        if _rng(self).random() < self.prob:
            return hflip(img)
        return _hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        self.prob = prob
        self.generator = generator

    def _apply_image(self, img):
        if _rng(self).random() < self.prob:
            return vflip(img)
        return _hwc(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear", keys=None, generator=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.generator = generator

    def _apply_image(self, img):
        arr = _hwc(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _rng(self).uniform(*self.scale) * area
            ar = _rng(self).uniform(*self.ratio)
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if cw <= w and ch <= h:
                i = _rng(self).randint(0, h - ch)
                j = _rng(self).randint(0, w - cw)
                return Resize(self.size)._apply_image(
                    arr[i:i + ch, j:j + cw])
        return Resize(self.size)._apply_image(arr)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return np.transpose(_hwc(img), self.order)


class Pad(BaseTransform):
    """Constant padding: an int, ``[left/right, top/bottom]`` or
    ``[left, top, right, bottom]``."""

    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = (padding if isinstance(padding, (list, tuple))
                        else [padding] * 4)
        self.fill = fill

    def _apply_image(self, img):
        arr = _hwc(img)
        p = self.padding
        if len(p) == 2:
            p = [p[0], p[1], p[0], p[1]]
        return np.pad(arr, ((p[1], p[3]), (p[0], p[2]), (0, 0)),
                      constant_values=self.fill)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return _hwc(img)[:, ::-1].copy()


def vflip(img):
    return _hwc(img)[::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def crop(img, top, left, height, width):
    return _hwc(img)[top:top + height, left:left + width]


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(img)
