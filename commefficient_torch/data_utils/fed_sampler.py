"""FedSampler: random client sampling with per-client cursors, the port's
own copy of ``commefficient_tpu/data_utils/fed_sampler.py`` (full
participation; the participation, requeue, quarantine and churn layers
are a later slice, ROADMAP.md queue 1 item 6).

Per epoch: shuffle within each client, then per step sample
``num_workers`` clients uniformly without replacement from the
non-exhausted set and take ``local_batch_size`` (or all remaining, when
-1) items from each; the epoch ends when every client is exhausted. The
global ``np.random`` is drawn in the same calls and order as the JAX
sampler, so the same seed gives the same cohorts. ``get_state`` /
``set_state`` are the checkpoint seam (the JAX keys ``permuted`` and
``cursor``; the participation layer's ``retry`` and ``quarantined`` come
with that layer).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FedSampler"]


class FedSampler:
    def __init__(self, dataset, num_workers, local_batch_size):
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self._permuted = None   # active epoch's within-client permutation
        self._cursor = None     # active epoch's per-client consumption
        self._pending_state = None

    def iter_structured(self):
        """Yields ``(client_ids, [index array per client])`` per round."""
        data_per_client = np.asarray(self.dataset.data_per_client)
        cumsum = np.hstack([[0], np.cumsum(data_per_client)])
        if self._pending_state is not None:
            # resume mid-epoch (set_state): replay the saved permutation
            # and cursors instead of drawing a fresh epoch
            permuted = np.asarray(self._pending_state["permuted"], np.int64)
            cursor = np.array(self._pending_state["cursor"], np.int64)
            self._pending_state = None
        else:
            # zero-item clients draw nothing from the stream (as in the
            # JAX sampler, which skips them)
            permuted = np.hstack([
                s + np.random.permutation(n)
                for s, n in zip(cumsum, data_per_client) if n > 0
            ]) if np.any(data_per_client) else np.array([], dtype=int)
            cursor = np.zeros(self.dataset.num_clients, dtype=np.int64)
        self._permuted, self._cursor = permuted, cursor
        while True:
            alive = np.where(cursor < data_per_client)[0]
            if len(alive) == 0:
                return
            n = min(self.num_workers, len(alive))
            workers = np.random.choice(alive, n, replace=False)
            remaining = data_per_client[workers] - cursor[workers]
            if self.local_batch_size == -1:
                sizes = remaining
            else:
                sizes = np.clip(remaining, 0, self.local_batch_size)
            starts = cumsum[workers] + cursor[workers]
            per_client = [permuted[s:s + sz] for s, sz in zip(starts, sizes)]
            # advance before yielding: a get_state() taken while the
            # consumer holds this batch already counts it as consumed
            cursor[workers] += sizes
            yield workers, per_client

    # -- checkpoint seam ---------------------------------------------------

    def get_state(self):
        """Position of the active epoch (None before the first round):
        everything a mid-epoch ``set_state`` needs besides the global
        numpy RNG state."""
        if self._permuted is None:
            return None
        return {"permuted": self._permuted.copy(),
                "cursor": self._cursor.copy()}

    def set_state(self, state) -> None:
        """Arm a restored mid-epoch position: the NEXT ``iter_structured``
        continues that epoch from the saved cursors."""
        self._pending_state = {"permuted": np.asarray(state["permuted"]),
                               "cursor": np.asarray(state["cursor"])}
