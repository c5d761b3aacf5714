"""Per-dataset augmentation stacks, numpy host-side: the port's own copy of
``commefficient_tpu/data_utils/transforms.py``. Each transform maps one
HWC image (uint8, or float32 in [0, 1]) to an HWC float32 array and draws
its randomness from the global ``np.random`` in the JAX package's order,
so the same seed gives the same batches.

Stacks:
- CIFAR10/100 train: random crop 32 with reflect-pad 4, random horizontal
  flip, per-channel normalize; test: normalize.
- FEMNIST train: random crop 28 with constant-pad 2 (fill 1.0), random
  resized crop scale (0.8, 1.2) ratio (4/5, 5/4), random rotation +-5
  degrees (fill 1.0), normalize; test: normalize.
- ImageNet train: random resized crop 224, horizontal flip, normalize;
  val: resize 256 + center crop 224. The exported stacks fuse each into
  one native call per image (``FusedResizedCropFlip``,
  ``FusedResizeCenterCrop``, ``commefficient_torch/native.py``); the
  per-op stacks (``imagenet_*_transforms_py``) are their plain versions.

``native_spec`` marks the stacks that the loader's native batch path
(``native.image_batch``) computes: pad, crop, flip and normalize, with
the crop and flip drawn in this module's ``np.random`` order.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "cifar10_train_transforms",
    "cifar10_test_transforms",
    "cifar100_train_transforms",
    "cifar100_test_transforms",
    "femnist_train_transforms",
    "femnist_test_transforms",
    "imagenet_train_transforms",
    "imagenet_val_transforms",
    "Compose",
]

cifar10_mean = np.array((0.4914, 0.4822, 0.4465), np.float32)
cifar10_std = np.array((0.2471, 0.2435, 0.2616), np.float32)
cifar100_mean = np.array((0.5071, 0.4867, 0.4408), np.float32)
cifar100_std = np.array((0.2675, 0.2565, 0.2761), np.float32)
femnist_mean = np.array((0.9637,), np.float32)
femnist_std = np.array((0.1597,), np.float32)
imagenet_mean = np.array((0.485, 0.456, 0.406), np.float32)
imagenet_std = np.array((0.229, 0.224, 0.225), np.float32)


class Compose:
    def __init__(self, fns):
        self.fns = fns

    def __call__(self, img):
        for f in self.fns:
            img = f(img)
        return img


def _ensure_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_float(img):
    """uint8 [0,255] or float [0,1] → float32 [0,1] HWC."""
    img = _ensure_hwc(img)
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


def _resize_bilinear(img, out_h, out_w):
    """Minimal bilinear resize for HWC float arrays (host-side, small images)."""
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).astype(img.dtype)


def _draw_resized_crop_box(h, w, scale, ratio):
    """The RandomResizedCrop box draw (10-try rejection sampling, center
    fallback) as a shared helper: the per-op stack and the fused native
    stack MUST consume np.random in this exact order to stay batch-
    identical under one seed."""
    area = h * w
    for _ in range(10):
        target_area = area * np.random.uniform(*scale)
        log_ratio = np.log(ratio)
        aspect = np.exp(np.random.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = np.random.randint(0, h - ch + 1)
            j = np.random.randint(0, w - cw + 1)
            return i, j, ch, cw
    # fallback: center crop
    s = min(h, w)
    return (h - s) // 2, (w - s) // 2, s, s


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size, self.scale, self.ratio = size, scale, ratio

    def __call__(self, img):
        h, w = img.shape[:2]
        i, j, ch, cw = _draw_resized_crop_box(h, w, self.scale, self.ratio)
        crop = img[i:i + ch, j:j + cw]
        return _resize_bilinear(crop, self.size, self.size)


class RandomRotation:
    """Nearest-neighbor rotation by a small uniform angle (±degrees)."""

    def __init__(self, degrees, fill=0.0):
        self.degrees, self.fill = degrees, fill

    def __call__(self, img):
        theta = np.deg2rad(np.random.uniform(-self.degrees, self.degrees))
        h, w = img.shape[:2]
        cy, cx = (h - 1) / 2, (w - 1) / 2
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        ys = cy + (yy - cy) * np.cos(theta) - (xx - cx) * np.sin(theta)
        xs = cx + (yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
        yi = np.round(ys).astype(int)
        xi = np.round(xs).astype(int)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out = np.full_like(img, self.fill)
        out[valid] = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)][valid]
        return out


class Resize:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        h, w = img.shape[:2]
        if h < w:
            return _resize_bilinear(img, self.size, int(round(w * self.size / h)))
        return _resize_bilinear(img, int(round(h * self.size / w)), self.size)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        h, w = img.shape[:2]
        i, j = (h - self.size) // 2, (w - self.size) // 2
        return img[i:i + self.size, j:j + self.size]


cifar10_train_transforms = Compose([
    to_float,
    RandomCrop(32, padding=4, mode="reflect"),
    RandomHorizontalFlip(),
    Normalize(cifar10_mean, cifar10_std),
])
cifar10_test_transforms = Compose([to_float, Normalize(cifar10_mean, cifar10_std)])

cifar100_train_transforms = Compose([
    to_float,
    RandomCrop(32, padding=4, mode="reflect"),
    RandomHorizontalFlip(),
    Normalize(cifar100_mean, cifar100_std),
])
cifar100_test_transforms = Compose([to_float, Normalize(cifar100_mean, cifar100_std)])

# native_spec marks stacks expressible as the fused native
# pad/crop/flip/normalize kernel (commefficient_torch.native.image_batch); the
# loader's fast path keys on it. ``rng_draws``: ("crop", "flip") per item, in
# the exact np.random draw order of the Python stack above — the fast path
# replays the same draws so both paths produce identical batches.
cifar10_train_transforms.native_spec = dict(
    pad=4, size=32, mean=cifar10_mean, std=cifar10_std, train=True)
cifar10_test_transforms.native_spec = dict(
    pad=0, size=32, mean=cifar10_mean, std=cifar10_std, train=False)
cifar100_train_transforms.native_spec = dict(
    pad=4, size=32, mean=cifar100_mean, std=cifar100_std, train=True)
cifar100_test_transforms.native_spec = dict(
    pad=0, size=32, mean=cifar100_mean, std=cifar100_std, train=False)

femnist_train_transforms = Compose([
    to_float,
    RandomCrop(28, padding=2, mode="constant", fill=1.0),
    RandomResizedCrop(28, scale=(0.8, 1.2), ratio=(4 / 5, 5 / 4)),
    RandomRotation(5, fill=1.0),
    Normalize(femnist_mean, femnist_std),
])
femnist_test_transforms = Compose([to_float, Normalize(femnist_mean, femnist_std)])
femnist_test_transforms.native_spec = dict(
    pad=0, size=28, mean=femnist_mean, std=femnist_std, train=False)

# Pure per-op ImageNet stacks (the reference recipe). Kept importable for
# parity tests; the exported stacks below fuse the whole pipeline into one
# native call per image (variable JPEG sizes preclude the batch-level
# store fusion the CIFAR stacks use).
imagenet_train_transforms_py = Compose([
    to_float,
    RandomResizedCrop(224),
    RandomHorizontalFlip(),
    Normalize(imagenet_mean, imagenet_std),
])
imagenet_val_transforms_py = Compose([
    to_float,
    Resize(256),
    CenterCrop(224),
    Normalize(imagenet_mean, imagenet_std),
])


class FusedResizedCropFlip:
    """ImageNet train stack as ONE native call per image: the crop box and
    flip are drawn with np.random in the exact order of the per-op stack
    (RandomResizedCrop's rejection loop, then RandomHorizontalFlip), then
    crop+bilinear-resize+flip+normalize run fused in C
    (native.resized_crop). Matches the per-op stack to float rounding
    (the u8->float conversion commutes with the bilinear blend)."""

    def __init__(self, size, mean, std, scale=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3)):
        self.size, self.mean, self.std = size, mean, std
        self.scale, self.ratio = scale, ratio

    def __call__(self, img):
        from commefficient_torch import native

        img = _ensure_hwc(img)
        h, w = img.shape[:2]
        by, bx, bh, bw = _draw_resized_crop_box(h, w, self.scale,
                                                self.ratio)
        flip = np.random.rand() < 0.5
        return native.resized_crop(img, (by, bx, bh, bw), self.size,
                                   self.size, flip, self.mean, self.std,
                                   clip_mode=0)


class FusedResizeCenterCrop:
    """ImageNet val stack (Resize(resize) + CenterCrop(size) + normalize)
    as ONE native affine-sampled bilinear pass: sample positions are the
    two-stage pipeline's exact source positions (clip_mode=1), so no
    full-size resized intermediate is ever materialized."""

    def __init__(self, resize, size, mean, std):
        self.resize, self.size = resize, size
        self.mean, self.std = mean, std

    def __call__(self, img):
        from commefficient_torch import native

        img = _ensure_hwc(img)
        h, w = img.shape[:2]
        if h < w:
            oh, ow = self.resize, int(round(w * self.resize / h))
        else:
            oh, ow = int(round(h * self.resize / w)), self.resize
        i0, j0 = (oh - self.size) // 2, (ow - self.size) // 2
        sy, sx = h / oh, w / ow
        box = (i0 * sy, j0 * sx, self.size * sy, self.size * sx)
        return native.resized_crop(img, box, self.size, self.size, False,
                                   self.mean, self.std, clip_mode=1)


imagenet_train_transforms = FusedResizedCropFlip(
    224, imagenet_mean, imagenet_std)
imagenet_val_transforms = FusedResizeCenterCrop(
    256, 224, imagenet_mean, imagenet_std)
