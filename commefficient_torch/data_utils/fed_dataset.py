"""FedDataset — client-partitioned dataset base.

Behavioral parity with reference data_utils/fed_dataset.py:9-98, torch-free:

- on-disk layout: per-client files + ``stats.json`` holding
  ``images_per_client`` / ``num_val_images``, prepared once;
- flat global index → (client_id, idx_within_client) via cumsum/searchsorted;
- ``do_iid``: a fixed random permutation of the index space re-assigns data to
  synthetic equal-size clients;
- non-iid with ``num_clients`` set: each natural partition is split across
  ``num_clients / num_natural_partitions`` clients;
- val items carry the client_id −1 sentinel (the train/val discriminator the
  worker relies on — reference fed_worker.py:51-52).

``__getitem__`` returns numpy (HWC uint8/float32); batching into
client-major arrays lives in ``FedLoader`` (data_utils/loader.py). This is
the port's own copy of ``commefficient_tpu/data_utils/fed_dataset.py``:
the same seed gives the same partition and the same items.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["FedDataset"]


class FedDataset:
    def __init__(self, dataset_dir, dataset_name, transform=None,
                 do_iid=False, num_clients=None, train=True, download=False,
                 seed=None):
        self.dataset_dir = dataset_dir
        self.dataset_name = dataset_name
        self.transform = transform
        self.do_iid = do_iid
        self._num_clients = num_clients
        self.type = "train" if train else "val"

        if not do_iid and num_clients == 1:
            raise ValueError("can't have 1 client when non-iid")

        if not os.path.exists(self.stats_fn()):
            os.makedirs(self.dataset_dir, exist_ok=True)
            self.prepare_datasets(download=download)

        self._load_meta(train)

        if self.do_iid:
            # global process RNG like the reference (seeded by entry script)
            rng = np.random if seed is None else np.random.RandomState(seed)
            self.iid_shuffle = rng.permutation(len(self))

    # -- metadata ----------------------------------------------------------

    @property
    def data_per_client(self):
        if self.do_iid:
            num_data = len(self)
            ipc = np.full(self.num_clients, num_data // self.num_clients,
                          dtype=np.int64)
            extra = num_data % self.num_clients
            if extra:
                ipc[self.num_clients - extra:] += 1
            return ipc
        if self._num_clients is None:
            return np.asarray(self.images_per_client)
        # split each natural partition across num_clients/num_partitions
        out = []
        per_class = self._num_clients // len(self.images_per_client)
        for n in self.images_per_client:
            split = [n // per_class] * per_class
            split[-1] += n % per_class
            out.extend(split)
        return np.asarray(out)

    @property
    def num_clients(self):
        return (self._num_clients if self._num_clients is not None
                else len(self.images_per_client))

    def _load_meta(self, train):
        with open(self.stats_fn()) as f:
            stats = json.load(f)
        self.images_per_client = np.array(stats["images_per_client"])
        self.num_val_images = stats["num_val_images"]

    def __len__(self):
        if self.type == "train":
            return int(np.sum(self.images_per_client))
        return self.num_val_images

    # -- item access -------------------------------------------------------

    def __getitem__(self, idx):
        if self.type == "train":
            orig_idx = idx
            if self.do_iid:
                idx = self.iid_shuffle[idx]
            cumsum = np.cumsum(self.images_per_client)
            natural_client = int(np.searchsorted(cumsum, idx, side="right"))
            start = cumsum[natural_client - 1] if natural_client else 0
            image, target = self._get_train_item(natural_client, int(idx - start))
            # re-derive the *reported* client id from data_per_client
            # (reference fed_dataset.py:82-85)
            cumsum = np.cumsum(self.data_per_client)
            client_id = int(np.searchsorted(cumsum, orig_idx, side="right"))
        else:
            image, target = self._get_val_item(idx)
            client_id = -1

        if self.transform is not None:
            image = self.transform(image)
        return client_id, image, target

    # -- subclass hooks ----------------------------------------------------

    def prepare_datasets(self, download=False):
        raise NotImplementedError

    def _get_train_item(self, client_id, idx_within_client):
        raise NotImplementedError

    def _get_val_item(self, idx):
        raise NotImplementedError

    def stats_fn(self):
        return os.path.join(self.dataset_dir, "stats.json")
