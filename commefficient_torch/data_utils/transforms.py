"""CIFAR augmentation stacks, numpy host-side: the port's own copy of the
CIFAR part of ``commefficient_tpu/data_utils/transforms.py``. Each
transform maps one HWC uint8 image to an HWC float32 array and draws its
randomness from the global ``np.random`` in the JAX package's order, so the
same seed gives the same batches.

- CIFAR10/100 train: random crop 32 with reflect-pad 4, random horizontal
  flip, per-channel normalize; test: normalize.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "cifar10_train_transforms",
    "cifar10_test_transforms",
    "cifar100_train_transforms",
    "cifar100_test_transforms",
    "Compose",
]

cifar10_mean = np.array((0.4914, 0.4822, 0.4465), np.float32)
cifar10_std = np.array((0.2471, 0.2435, 0.2616), np.float32)
cifar100_mean = np.array((0.5071, 0.4867, 0.4408), np.float32)
cifar100_std = np.array((0.2675, 0.2565, 0.2761), np.float32)


class Compose:
    def __init__(self, fns):
        self.fns = fns

    def __call__(self, img):
        for f in self.fns:
            img = f(img)
        return img


def to_float(img):
    """uint8 [0,255] or float [0,1] -> float32 [0,1] HWC."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


class Normalize:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, img):
        return (img - self.mean) / self.std


class RandomCrop:
    def __init__(self, size, padding, mode="reflect", fill=0.0):
        self.size, self.padding, self.mode, self.fill = size, padding, mode, fill

    def __call__(self, img):
        p = self.padding
        if self.mode == "reflect":
            img = np.pad(img, ((p, p), (p, p), (0, 0)), mode="reflect")
        else:
            img = np.pad(img, ((p, p), (p, p), (0, 0)), mode="constant",
                         constant_values=self.fill)
        h = np.random.randint(0, img.shape[0] - self.size + 1)
        w = np.random.randint(0, img.shape[1] - self.size + 1)
        return img[h:h + self.size, w:w + self.size]


class RandomHorizontalFlip:
    def __call__(self, img):
        if np.random.rand() < 0.5:
            return img[:, ::-1].copy()
        return img


cifar10_train_transforms = Compose([
    to_float,
    RandomCrop(32, padding=4, mode="reflect"),
    RandomHorizontalFlip(),
    Normalize(cifar10_mean, cifar10_std),
])
cifar10_test_transforms = Compose([to_float,
                                   Normalize(cifar10_mean, cifar10_std)])

cifar100_train_transforms = Compose([
    to_float,
    RandomCrop(32, padding=4, mode="reflect"),
    RandomHorizontalFlip(),
    Normalize(cifar100_mean, cifar100_std),
])
cifar100_test_transforms = Compose([to_float,
                                    Normalize(cifar100_mean, cifar100_std)])
