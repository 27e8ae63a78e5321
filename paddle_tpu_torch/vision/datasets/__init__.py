"""Vision datasets. Counterpart of ``paddle_tpu/vision/datasets``
(``MNIST``, ``FashionMNIST``, ``Cifar10``, ``Cifar100``, ``FakeData``,
``DatasetFolder``, ``ImageFolder``, ``Flowers``, ``VOC2012``), numpy-only
and host-side like the JAX package's.

File-backed datasets read standard local archives. Nothing is
downloaded: where the files are absent a dataset is synthetic, drawn
from the same seeds as the JAX package's, so both yield the same arrays.
``download`` is accepted and ignored. Samples are numpy arrays (or what
the ``transform`` returns); ``io.DataLoader`` batches them onto its
device.
"""
from __future__ import annotations

import gzip
import os
import pickle
import tarfile

import numpy as np

from ...io.dataset import Dataset

__all__ = ["Cifar10", "Cifar100", "DatasetFolder", "FakeData",
           "FashionMNIST", "Flowers", "ImageFolder", "MNIST", "VOC2012"]


def image_load(path):
    """An image file as a numpy array: ``.npy`` directly, other formats
    through PIL where it is installed."""
    if str(path).endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"image_load: {path} is not .npy and PIL is not "
                           "installed") from None
    with Image.open(path) as img:
        return np.asarray(img)


class _SyntheticImages(Dataset):
    def __init__(self, num, shape, num_classes, transform=None, seed=0):
        self.num = num
        self.shape = shape
        self.num_classes = num_classes
        self.transform = transform
        self._rng = np.random.default_rng(seed)
        self.images = self._rng.integers(
            0, 256, size=(num,) + shape, dtype=np.uint8)
        self.labels = self._rng.integers(0, num_classes, size=(num,)).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return self.num


class MNIST(Dataset):
    """Loads idx-format MNIST from image_path/label_path; synthesizes 28x28
    data when files are absent."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.transform = transform
        if image_path and os.path.exists(image_path) and label_path and \
                os.path.exists(label_path):
            with gzip.open(image_path, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8, offset=16)
            self.images = data.reshape(-1, 28, 28)
            with gzip.open(label_path, "rb") as f:
                self.labels = np.frombuffer(f.read(), np.uint8, offset=8).astype(np.int64)
        else:
            n = 1024 if mode == "train" else 256
            synth = _SyntheticImages(n, (28, 28), 10, seed=0 if mode == "train" else 1)
            self.images = synth.images
            self.labels = synth.labels

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img[..., None])
        else:
            img = (img / 255.0)[None, :, :]  # CHW, [0,1]
        return img, np.asarray([self.labels[idx]])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        self.num_classes = self.NUM_CLASSES
        if data_file and os.path.exists(data_file):
            self.images, self.labels = self._load(data_file, mode)
        else:
            n = 1024 if mode == "train" else 256
            synth = _SyntheticImages(n, (32, 32, 3), self.num_classes,
                                     seed=2 if mode == "train" else 3)
            self.images = synth.images
            self.labels = synth.labels

    def _load(self, path, mode):
        images, labels = [], []
        with tarfile.open(path) as tf:
            # CIFAR-10 members: data_batch_*/test_batch;
            # CIFAR-100 members: train/test
            if mode == "train":
                wanted = ("data_batch", "train")
            else:
                wanted = ("test_batch", "test")
            names = [n for n in tf.getnames()
                     if any(os.path.basename(n) == w
                            or os.path.basename(n).startswith(w + "_")
                            for w in wanted)]
            for name in sorted(names):
                d = pickle.load(tf.extractfile(name), encoding="bytes")
                images.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
                labels.extend(d.get(b"labels", d.get(b"fine_labels")))
        return np.concatenate(images), np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]])

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    # class attribute so the synthetic fallback draws 100-class labels
    # (setting num_classes after super().__init__ left labels in 0..9)
    NUM_CLASSES = 100


class FakeData(_SyntheticImages):
    """Explicit synthetic dataset (like torchvision FakeData)."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=1000,
                 transform=None):
        shape = tuple(image_shape)
        if shape[0] in (1, 3):  # CHW → HWC storage
            shape = (shape[1], shape[2], shape[0])
        super().__init__(size, shape, num_classes, transform)


class DatasetFolder(Dataset):
    """Directory-per-class dataset (reference:
    vision/datasets/folder.py::DatasetFolder): root/<class>/<file>."""

    IMG_EXTS = (".npy", ".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        exts = tuple(e.lower() for e in (extensions or self.IMG_EXTS))
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for f in sorted(files):
                    path = os.path.join(dirpath, f)
                    ok = (is_valid_file(path) if is_valid_file
                          else f.lower().endswith(exts))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"found no valid files under {root}")

    @staticmethod
    def _default_loader(path):
        return np.asarray(image_load(path))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat/recursive image listing without labels (reference:
    vision/datasets/folder.py::ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._default_loader
        exts = tuple(e.lower()
                     for e in (extensions or DatasetFolder.IMG_EXTS))
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                path = os.path.join(dirpath, f)
                ok = (is_valid_file(path) if is_valid_file
                      else f.lower().endswith(exts))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise RuntimeError(f"found no valid files under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(_SyntheticImages):
    """Flowers-102 (file-gated in this environment; synthetic fallback
    keeps pipelines runnable — reference vision/datasets/flowers.py)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        n = 512 if mode == "train" else 128
        super().__init__(n, (64, 64, 3), 102, transform=transform,
                         seed=0 if mode == "train" else 1)


class VOC2012(_SyntheticImages):
    """VOC2012 segmentation (file-gated; synthetic fallback — reference
    vision/datasets/voc2012.py). Returns (image, label_mask)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        n = 128 if mode == "train" else 32
        super().__init__(n, (64, 64, 3), 21, transform=transform,
                         seed=2 if mode == "train" else 3)
        rng = np.random.default_rng(9)
        self.masks = rng.integers(0, 21, size=(n, 64, 64)).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]
