"""FedImageNet: 1 wnid = 1 client. The port's own copy of
``commefficient_tpu/data_utils/fed_imagenet.py``.

Expects ImageNet pre-extracted under
``dataset_dir/{train,val}/<wnid>/*.JPEG``; ``prepare_datasets`` only
writes ``stats.json`` (images a client, in sorted-wnid order). JPEG/PNG
files are decoded with PIL, imported only when one is read.

Zero-egress fallback: with no image tree present, a synthetic tree of
``.npy`` 64 x 64 RGB images is generated
(``COMMEFFICIENT_SYNTHETIC_CLIENTS`` wnid-clients, default 16;
``COMMEFFICIENT_SYNTHETIC_PER_CLASS`` train images each, default 8, and a
quarter of that for val), read at prepare time.
"""

from __future__ import annotations

import json
import os

import numpy as np

from commefficient_torch.data_utils.fed_dataset import FedDataset

__all__ = ["FedImageNet"]

_EXTS = (".jpeg", ".jpg", ".png", ".npy")


def _list_tree(split_dir):
    if not os.path.isdir(split_dir):
        return []
    samples = []
    for ci, wnid in enumerate(sorted(os.listdir(split_dir))):
        cdir = os.path.join(split_dir, wnid)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(_EXTS):
                samples.append((os.path.join(cdir, fn), ci))
    return samples


def _make_synthetic_tree(root, seed=0):
    n_clients = int(os.environ.get("COMMEFFICIENT_SYNTHETIC_CLIENTS", 16))
    per_train = int(os.environ.get("COMMEFFICIENT_SYNTHETIC_PER_CLASS", 8))
    rng = np.random.RandomState(seed)
    for split, per in (("train", per_train), ("val", max(1, per_train // 4))):
        for c in range(n_clients):
            d = os.path.join(root, split, f"synthwnid{c:04d}")
            os.makedirs(d, exist_ok=True)
            for i in range(per):
                img = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
                np.save(os.path.join(d, f"img{i}.npy"), img)


def _load_image(path):
    """An HWC uint8 image: ``.npy`` with numpy; a JPEG or PNG with PIL,
    imported only for such a file (the synthetic tree needs none)."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: decoding a JPEG/PNG image needs PIL (Pillow), which "
            "this environment lacks; the synthetic .npy tree needs no "
            "PIL") from e

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class FedImageNet(FedDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.train_samples = _list_tree(os.path.join(self.dataset_dir, "train"))
        self.val_samples = _list_tree(os.path.join(self.dataset_dir, "val"))

    def prepare_datasets(self, download=False):
        samples = _list_tree(os.path.join(self.dataset_dir, "train"))
        if not samples:
            # the reference raises "Can't download ImageNet, sry" here
            # (reference fed_imagenet.py prepare path) and requires a
            # pre-extracted tree; with zero egress we fall through to the
            # synthetic wnid tree like every other dataset shim in this
            # repo so the plumbing stays runnable end to end
            print("FedImageNet: no image tree under "
                  f"{self.dataset_dir}/train — generating a synthetic one "
                  "(real runs need pre-extracted ImageNet)")
            _make_synthetic_tree(self.dataset_dir)
            samples = _list_tree(os.path.join(self.dataset_dir, "train"))
        images_per_client = []
        target = -1
        for _, t in samples:
            if t != target:
                images_per_client.append(0)
                target = t
            images_per_client[-1] += 1
        num_val = len(_list_tree(os.path.join(self.dataset_dir, "val")))
        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": images_per_client,
                       "num_val_images": num_val}, f)

    def _get_train_item(self, client_id, idx_within_client):
        cumsum = np.hstack([[0], np.cumsum(self.images_per_client)[:-1]])
        path, target = self.train_samples[int(cumsum[client_id]) + idx_within_client]
        return _load_image(path), target

    def _get_val_item(self, idx):
        path, target = self.val_samples[idx]
        return _load_image(path), target
