"""The port's vision datasets and transforms against the JAX package's,
on the CPU: every synthetic dataset yields the same arrays and labels
(exactly), the folder datasets list and load the same samples, and each
ported transform gives the same array (exactly; the random ones with
python's ``random`` seeded alike on the JAX side and ``generator=
random.Random(seed)`` on the port's). ``ToTensor`` gives a CPU tensor.
The JAX datasets are made with ``download=False``: nothing is fetched.
"""
import random

import numpy as np
import pytest
import torch

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.vision import datasets as ds
from paddle_tpu_torch.vision import transforms as T


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(getattr(x, "_data", x))


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


DATASETS = {
    "MNIST train": (lambda m: m.MNIST(mode="train", download=False), 1024),
    "MNIST test": (lambda m: m.MNIST(mode="test", download=False), 256),
    "FashionMNIST": (lambda m: m.FashionMNIST(download=False), 1024),
    "Cifar10 train": (lambda m: m.Cifar10(mode="train"), 1024),
    "Cifar10 test": (lambda m: m.Cifar10(mode="test"), 256),
    "Cifar100": (lambda m: m.Cifar100(), 1024),
    "FakeData": (lambda m: m.FakeData(size=20, image_shape=(3, 16, 12),
                                      num_classes=7), 20),
    "Flowers": (lambda m: m.Flowers(mode="test"), 128),
    "VOC2012": (lambda m: m.VOC2012(mode="test"), 32),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_synthetic_dataset_matches_jax(name):
    make, n = DATASETS[name]
    got, want = make(ds), make(jds)
    assert len(got) == len(want) == n
    for i in (0, 1, n - 1):
        for g, w in zip(got[i], want[i]):
            _same(g, w)
    if hasattr(want, "labels"):
        _same(got.labels, want.labels)
    if name == "Cifar100":
        assert got.labels.max() > 9


def test_folder_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for i in range(3):
            np.save(tmp_path / c / f"{i}.npy",
                    rng.integers(0, 256, (4, 5, 3), dtype=np.uint8))
    (tmp_path / "dog" / "notes.txt").write_text("skipped")
    got, want = ds.DatasetFolder(str(tmp_path)), jds.DatasetFolder(
        str(tmp_path))
    assert got.classes == want.classes == ["cat", "dog"]
    assert got.samples == want.samples
    for i in range(len(want)):
        _same(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]
    gi, wi = ds.ImageFolder(str(tmp_path)), jds.ImageFolder(str(tmp_path))
    assert gi.samples == wi.samples
    _same(gi[2][0], wi[2][0])


def _image(seed=0, shape=(12, 10, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


# name: (port transform, JAX transform); the random ones take a seed
TRANSFORMS = {
    "ToTensor": (lambda: T.ToTensor(), lambda: jT.ToTensor()),
    "ToTensor HWC": (lambda: T.ToTensor("HWC"), lambda: jT.ToTensor("HWC")),
    "Normalize": (lambda: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                      data_format="HWC"),
                  lambda: jT.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                       data_format="HWC")),
    "Resize": (lambda: T.Resize((7, 13)), lambda: jT.Resize((7, 13))),
    "CenterCrop": (lambda: T.CenterCrop(5), lambda: jT.CenterCrop(5)),
    "Transpose": (lambda: T.Transpose(), lambda: jT.Transpose()),
    "Pad": (lambda: T.Pad([1, 2, 3, 0], fill=7),
            lambda: jT.Pad([1, 2, 3, 0], fill=7)),
    "Pad 2": (lambda: T.Pad([2, 1]), lambda: jT.Pad([2, 1])),
    "Compose": (lambda: T.Compose([T.CenterCrop(8), T.ToTensor(),
                                   T.Normalize(0.5, 0.25)]),
                lambda: jT.Compose([jT.CenterCrop(8), jT.ToTensor(),
                                    jT.Normalize(0.5, 0.25)])),
}
RANDOM = {
    "RandomCrop": (lambda g: T.RandomCrop(6, padding=2, generator=g),
                   lambda: jT.RandomCrop(6, padding=2)),
    "RandomHorizontalFlip": (
        lambda g: T.RandomHorizontalFlip(generator=g),
        lambda: jT.RandomHorizontalFlip()),
    "RandomVerticalFlip": (lambda g: T.RandomVerticalFlip(generator=g),
                           lambda: jT.RandomVerticalFlip()),
    "RandomResizedCrop": (lambda g: T.RandomResizedCrop(8, generator=g),
                          lambda: jT.RandomResizedCrop(8)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    mine, theirs = TRANSFORMS[name]
    img = _image()
    got = mine()(img)
    if name.startswith(("ToTensor", "Compose")):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _same(got, theirs()(img))


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_transform_matches_jax(name):
    mine, theirs = RANDOM[name]
    t, jt = mine(random.Random(5)), theirs()
    random.seed(5)
    for i in range(6):
        _same(t(_image(i)), jt(_image(i)))


def test_functional_forms_match_jax():
    img = _image(1)
    for f, args in (("to_tensor", ()), ("resize", ((5, 4),)),
                    ("hflip", ()), ("vflip", ()), ("center_crop", (4,)),
                    ("crop", (1, 2, 5, 3)), ("pad", (2,))):
        _same(getattr(T, f)(img, *args), getattr(jT, f)(img, *args))
    t = T.to_tensor(img)
    _same(T.normalize(t, [0.1] * 3, [0.5] * 3),
          jT.normalize(jT.to_tensor(img), [0.1] * 3, [0.5] * 3))


def test_cifar10_through_the_loader():
    """Transforms run in the dataset, the loader stacks the CPU tensors
    and labels on its device."""
    data = ds.Cifar10(mode="test", transform=T.Compose([
        T.ToTensor(), T.Normalize([0.5] * 3, [0.25] * 3)]))
    x, y = next(iter(DataLoader(data, batch_size=8, device="cpu")))
    assert x.shape == (8, 3, 32, 32) and x.dtype == torch.float32
    assert y.shape == (8, 1) and y.dtype == torch.int64
    want = (data.images[:8].astype(np.float32) / 255.0 - 0.5) / 0.25
    np.testing.assert_allclose(x.numpy(), want.transpose(0, 3, 1, 2),
                               rtol=1e-6, atol=1e-6)
