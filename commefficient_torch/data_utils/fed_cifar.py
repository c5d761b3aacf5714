"""FedCIFAR10 / FedCIFAR100 — natural partition: 1 class = 1 client.

Parity with reference data_utils/fed_cifar.py:13-100: ``prepare_datasets``
writes one ``client{i}.npy`` per class plus ``test.npz`` and ``stats.json``;
train target *is* the client id; all data held in memory.

Data sourcing (zero-egress environment): ``prepare_datasets`` reads the
standard CIFAR python pickle batches if present under ``dataset_dir``
(``cifar-10-batches-py`` / ``cifar-100-python``); otherwise it falls back to a
deterministic synthetic dataset with the same shapes and class-conditional
structure (class-dependent mean pattern + noise) so training and benchmarks
remain meaningful. Set ``COMMEFFICIENT_SYNTHETIC_PER_CLASS`` to control the
synthetic per-class size (default 5000/500, CIFAR-real sizes).

The port's own copy of ``commefficient_tpu/data_utils/fed_cifar.py``: the
same files on disk and the same synthetic data for the same settings.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from commefficient_torch.data_utils.fed_dataset import FedDataset

__all__ = ["FedCIFAR10", "FedCIFAR100"]


def _load_cifar10_raw(root):
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None
    def load(fn):
        with open(os.path.join(d, fn), "rb") as f:
            return pickle.load(f, encoding="latin1")
    train_x, train_y = [], []
    for i in range(1, 6):
        b = load(f"data_batch_{i}")
        train_x.append(b["data"])
        train_y.extend(b["labels"])
    tb = load("test_batch")
    train_x = np.concatenate(train_x).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    test_x = np.asarray(tb["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return (train_x, np.asarray(train_y), test_x, np.asarray(tb["labels"]), 10)


def _load_cifar100_raw(root):
    d = os.path.join(root, "cifar-100-python")
    if not os.path.isdir(d):
        return None
    def load(fn):
        with open(os.path.join(d, fn), "rb") as f:
            return pickle.load(f, encoding="latin1")
    tr, te = load("train"), load("test")
    train_x = np.asarray(tr["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    test_x = np.asarray(te["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return (train_x, np.asarray(tr["fine_labels"]), test_x,
            np.asarray(te["fine_labels"]), 100)


def _synthetic(num_classes, seed=0):
    per_class = int(os.environ.get("COMMEFFICIENT_SYNTHETIC_PER_CLASS", 5000))
    val_per_class = max(1, per_class // 10)
    rng = np.random.RandomState(seed)
    protos = rng.randint(0, 255, size=(num_classes, 32, 32, 3))

    def gen(n_per_class):
        xs, ys = [], []
        for c in range(num_classes):
            noise = rng.randint(-60, 60, size=(n_per_class, 32, 32, 3))
            xs.append(np.clip(protos[c][None] * 0.5 + noise + 64, 0, 255)
                      .astype(np.uint8))
            ys.append(np.full(n_per_class, c, np.int64))
        return np.concatenate(xs), np.concatenate(ys)

    train_x, train_y = gen(per_class)
    test_x, test_y = gen(val_per_class)
    return train_x, train_y, test_x, test_y, num_classes


class FedCIFAR10(FedDataset):
    _raw_loader = staticmethod(_load_cifar10_raw)
    _n_classes = 10

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.type == "train":
            # one contiguous store; client_datasets are views into it
            self._store = np.ascontiguousarray(np.concatenate(
                [np.load(self.client_fn(i))
                 for i in range(len(self.images_per_client))], axis=0))
            bounds = np.cumsum(self.images_per_client)[:-1]
            self.client_datasets = np.split(self._store, bounds, axis=0)
            self._store_targets = np.repeat(
                np.arange(len(self.images_per_client), dtype=np.int64),
                self.images_per_client)
        else:
            with np.load(self.test_fn()) as t:
                self.test_images = t["test_images"]
                self.test_targets = t["test_targets"]

    def prepare_datasets(self, download=False):
        raw = self._raw_loader(self.dataset_dir)
        if raw is None:
            raw = _synthetic(self._n_classes)
        train_x, train_y, test_x, test_y, n_classes = raw

        images_per_client = []
        for c in range(n_classes):
            sel = train_x[train_y == c]
            images_per_client.append(len(sel))
            fn = self.client_fn(c)
            if os.path.exists(fn):
                raise RuntimeError("won't overwrite existing split")
            np.save(fn, sel)
        np.savez(self.test_fn(), test_images=test_x, test_targets=test_y)
        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": images_per_client,
                       "num_val_images": int(len(test_y))}, f)

    def _get_train_item(self, client_id, idx_within_client):
        # train target IS the client id (reference fed_cifar.py:77-84)
        return self.client_datasets[client_id][idx_within_client], client_id

    def native_train_access(self):
        # store rows are the natural concatenation: target = the natural
        # client (the class), as _get_train_item gives it
        return {"store": self._store, "targets": self._store_targets}

    def native_val_access(self):
        return {"store": self.test_images,
                "targets": np.asarray(self.test_targets, np.int64)}

    def _get_val_item(self, idx):
        return self.test_images[idx], int(self.test_targets[idx])

    def client_fn(self, client_id):
        return os.path.join(self.dataset_dir, f"client{client_id}.npy")

    def test_fn(self):
        return os.path.join(self.dataset_dir, "test.npz")


class FedCIFAR100(FedCIFAR10):
    _raw_loader = staticmethod(_load_cifar100_raw)
    _n_classes = 100
