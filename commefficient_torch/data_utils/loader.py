"""FedLoader: client-major batch assembly, the port's own copy of the
numpy path of ``commefficient_tpu/data_utils/loader.py`` (the native C++
fast path and the prefetch thread are a later slice, ROADMAP.md queue 1
item 3; both produce the same batches as this path under one seed).

  train round batch: {
    client_ids:  (W,)  int32   sampled client per worker slot
    worker_mask: (W,)  float32 1.0 for real slots, 0.0 for padding
    inputs:      (W, B, H, W, C) float32, NHWC
    targets:     (W, B)  int64
    mask:        (W, B)  float32 per-datum validity
  }

with W = num_workers and B = local_batch_size (or the largest client when
-1). Val batches are flat: {inputs: (B, ...), targets: (B,), mask: (B,)}.

``collate_fn`` turns a list of items (each without its client id) into a
dict of stacked columns; ``cv_collate`` gives the image columns above,
``fed_persona.make_personachat_collate_fn`` GPT-2's.
"""

from __future__ import annotations

import numpy as np

from commefficient_torch.data_utils.fed_sampler import FedSampler

__all__ = ["FedLoader", "cv_collate"]


def cv_collate(items):
    """items: list of (image, target) -> stacked arrays."""
    images = np.stack([np.asarray(i, np.float32) for i, _ in items])
    targets = np.asarray([t for _, t in items], np.int64)
    return {"inputs": images, "targets": targets}


class FedLoader:
    def __init__(self, dataset, num_workers=1, local_batch_size=8,
                 collate_fn=cv_collate, val_batch_size=None):
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.collate_fn = collate_fn
        self.val_batch_size = val_batch_size or 64
        self.train = dataset.type == "train"
        if self.train:
            self.sampler = FedSampler(dataset, num_workers, local_batch_size)

    @property
    def batch_pad(self) -> int:
        if self.local_batch_size == -1:
            return int(np.max(self.dataset.data_per_client))
        return self.local_batch_size

    def steps_per_epoch(self) -> int:
        if self.local_batch_size == -1:
            return int(self.dataset.num_clients // self.num_workers)
        return int(np.ceil(len(self.dataset)
                           / (self.local_batch_size * self.num_workers)))

    def __len__(self):
        if self.train:
            return self.steps_per_epoch()
        return int(np.ceil(len(self.dataset) / self.val_batch_size))

    def _fetch(self, idx_list):
        items = []
        for i in idx_list:
            _cid, *rest = self.dataset[int(i)]
            items.append(tuple(rest))
        return self.collate_fn(items)

    def __iter__(self):
        if self.train:
            yield from self._train_iter()
        else:
            yield from self._val_iter()

    def _train_iter(self):
        W, B = self.num_workers, self.batch_pad
        for workers, idx_lists in self.sampler.iter_structured():
            n = len(workers)
            client_ids = np.zeros(W, np.int32)
            client_ids[:n] = workers
            worker_mask = np.zeros(W, np.float32)
            worker_mask[:n] = 1.0
            mask = np.zeros((W, B), np.float32)
            batch_cols = None
            for w, idxs in enumerate(idx_lists):
                cols = self._fetch(idxs)
                if batch_cols is None:
                    batch_cols = {
                        k: np.zeros((W, B) + v.shape[1:], v.dtype)
                        for k, v in cols.items()
                    }
                b = len(idxs)
                mask[w, :b] = 1.0
                for k, v in cols.items():
                    batch_cols[k][w, :b] = v
            batch = dict(batch_cols)
            batch["client_ids"] = client_ids
            batch["worker_mask"] = worker_mask
            batch["mask"] = mask
            yield batch

    def _val_iter(self):
        N = len(self.dataset)
        B = self.val_batch_size
        for start in range(0, N, B):
            idxs = range(start, min(start + B, N))
            cols = self._fetch(idxs)
            n = len(next(iter(cols.values())))
            mask = np.zeros(B, np.float32)
            mask[:n] = 1.0
            batch = {
                k: np.concatenate(
                    [v, np.zeros((B - n,) + v.shape[1:], v.dtype)], axis=0)
                if n < B else v
                for k, v in cols.items()
            }
            batch["mask"] = mask
            yield batch
