"""FedLoader: client-major batch assembly, and PrefetchLoader: the port's
own copy of ``commefficient_tpu/data_utils/loader.py``.

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

The native batch path: when the dataset has a contiguous store
(``native_train_access`` / ``native_val_access``), the transform is the
native pad/crop/flip/normalize (``transform.native_spec``) and the
collate is ``cv_collate``, a whole round is assembled by one
multithreaded call of ``commefficient_torch.native.image_batch`` instead
of a per-item loop (``use_native=None``, the default, takes it then;
``False`` keeps the per-item path). The crops and flips are drawn with
``np.random`` in the per-item stack's order, so one seed gives the same
batches on both paths, to float rounding (the library multiplies by
1/255 and 1/std where the stack divides).

``PrefetchLoader`` wraps any loader in a bounded queue filled by one
background thread (``--train_dataloader_workers`` /
``--val_dataloader_workers``): the native calls release the GIL, so batch
assembly overlaps the card's work. A consumer that stops early reaps the
thread; an error in the thread is raised to the consumer.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from commefficient_torch import native
from commefficient_torch.data_utils.fed_sampler import FedSampler

__all__ = ["FedLoader", "PrefetchLoader", "cv_collate"]


def cv_collate(items):
    """items: list of (image, target) -> stacked arrays."""
    images = np.stack([np.asarray(i, np.float32) for i, _ in items])
    targets = np.asarray([t for _, t in items], np.int64)
    return {"inputs": images, "targets": targets}


class FedLoader:
    def __init__(self, dataset, num_workers=1, local_batch_size=8,
                 collate_fn=cv_collate, val_batch_size=None,
                 use_native=None):
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.collate_fn = collate_fn
        self.val_batch_size = val_batch_size or 64
        self.train = dataset.type == "train"
        self.use_native = (self._native_ok() if use_native is None
                           else bool(use_native))
        if self.use_native and not self._native_ok():
            raise ValueError("use_native=True: the dataset has no "
                             "contiguous store or the transform is not "
                             "the native pad/crop/flip/normalize")
        if self.train:
            self.sampler = FedSampler(dataset, num_workers, local_batch_size)

    def _native_ok(self) -> bool:
        # the native path emits cv_collate's {inputs, targets}: a custom
        # collate_fn wins over it
        if self.collate_fn is not cv_collate:
            return False
        if getattr(self.dataset.transform, "native_spec", None) is None:
            return False
        access = (self.dataset.native_train_access() if self.train
                  else self.dataset.native_val_access())
        return access is not None

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
            yield from (self._train_iter_native() if self.use_native
                        else self._train_iter())
        else:
            yield from (self._val_iter_native() if self.use_native
                        else self._val_iter())

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

    # -- the native batch path ----------------------------------------------

    def _assemble_native(self, flat_idx, spec, access):
        """flat_idx: (M,) int64 flat dataset indices, -1 = padding. Returns
        (inputs (M, size, size, C) float32, targets (M,) int64)."""
        M = flat_idx.shape[0]
        rows = np.full(M, -1, np.int64)
        ok = flat_idx >= 0
        rows[ok] = self.dataset.store_rows(flat_idx[ok])
        crop_h = crop_w = flip = None
        if spec["train"]:
            # RandomCrop's draws (h, then w), then RandomHorizontalFlip's,
            # item by item: the per-item stack's np.random order
            crop_h = np.zeros(M, np.int32)
            crop_w = np.zeros(M, np.int32)
            flip = np.zeros(M, np.uint8)
            hi = 2 * spec["pad"] + 1
            for m in np.flatnonzero(ok):
                crop_h[m] = np.random.randint(0, hi)
                crop_w[m] = np.random.randint(0, hi)
                flip[m] = np.random.rand() < 0.5
        inputs = native.image_batch(
            access["store"], rows, crop_h, crop_w, flip, spec["pad"],
            spec["size"], spec["mean"], spec["std"])
        targets = np.zeros(M, np.int64)
        targets[ok] = access["targets"][rows[ok]]
        return inputs, targets

    def _train_iter_native(self):
        W, B = self.num_workers, self.batch_pad
        spec = self.dataset.transform.native_spec
        access = self.dataset.native_train_access()
        for workers, idx_lists in self.sampler.iter_structured():
            n = len(workers)
            client_ids = np.zeros(W, np.int32)
            client_ids[:n] = workers
            worker_mask = np.zeros(W, np.float32)
            worker_mask[:n] = 1.0
            mask = np.zeros((W, B), np.float32)
            flat_idx = np.full((W, B), -1, np.int64)
            for w, idxs in enumerate(idx_lists):
                b = len(idxs)
                mask[w, :b] = 1.0
                flat_idx[w, :b] = np.asarray(idxs, np.int64)
            inputs, targets = self._assemble_native(flat_idx.reshape(-1),
                                                    spec, access)
            yield {"inputs": inputs.reshape((W, B) + inputs.shape[1:]),
                   "targets": targets.reshape(W, B),
                   "client_ids": client_ids,
                   "worker_mask": worker_mask,
                   "mask": mask}

    def _val_iter_native(self):
        N = len(self.dataset)
        B = self.val_batch_size
        spec = self.dataset.transform.native_spec
        access = self.dataset.native_val_access()
        for start in range(0, N, B):
            n = min(B, N - start)
            # the val store's rows are the flat val indices
            rows = np.full(B, -1, np.int64)
            rows[:n] = np.arange(start, start + n)
            mask = np.zeros(B, np.float32)
            mask[:n] = 1.0
            inputs = native.image_batch(access["store"], rows, None, None,
                                        None, 0, spec["size"], spec["mean"],
                                        spec["std"])
            targets = np.zeros(B, np.int64)
            targets[:n] = access["targets"][start:start + n]
            yield {"inputs": inputs, "targets": targets, "mask": mask}


class PrefetchLoader:
    """A loader's batches from one background thread through a bounded
    queue of ``depth`` batches. Attributes other than iteration pass
    through to the wrapped loader."""

    _END = object()

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        if name == "loader":  # during unpickling: no recursion
            raise AttributeError(name)
        return getattr(self.loader, name)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err = []
        stop = threading.Event()

        def worker():
            try:
                for batch in self.loader:
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # raised again to the consumer
                err.append(e)
            finally:
                while True:  # the end marker lands even on a full queue
                    try:
                        q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    break
                yield item
        finally:
            # a consumer that stopped early: unblock the producer and
            # join it rather than leak it
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
            if err:
                raise err[0]
