"""FedSampler: random client sampling with per-client cursors, the port's
own copy of ``commefficient_tpu/data_utils/fed_sampler.py`` (full
participation; the participation, requeue, quarantine and churn layers
are a later slice, ROADMAP.md queue 1 item 7).

Per epoch: shuffle within each client, then per step sample
``num_workers`` clients uniformly without replacement from the
non-exhausted set and take ``local_batch_size`` (or all remaining, when
-1) items from each; the epoch ends when every client is exhausted. The
global ``np.random`` is drawn in the same calls and order as the JAX
sampler, so the same seed gives the same cohorts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FedSampler"]


class FedSampler:
    def __init__(self, dataset, num_workers, local_batch_size):
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size

    def iter_structured(self):
        """Yields ``(client_ids, [index array per client])`` per round."""
        data_per_client = np.asarray(self.dataset.data_per_client)
        cumsum = np.hstack([[0], np.cumsum(data_per_client)])
        # zero-item clients draw nothing from the stream (as in the JAX
        # sampler, which skips them)
        permuted = np.hstack([
            s + np.random.permutation(n)
            for s, n in zip(cumsum, data_per_client) if n > 0
        ]) if np.any(data_per_client) else np.array([], dtype=int)
        cursor = np.zeros(self.dataset.num_clients, dtype=np.int64)
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
            cursor[workers] += sizes
            yield workers, per_client
