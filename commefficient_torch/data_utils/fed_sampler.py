"""FedSampler: random client sampling with per-client cursors, the port's
own copy of ``commefficient_tpu/data_utils/fed_sampler.py``.

Per epoch: shuffle within each client, then per step sample a cohort from
the non-exhausted, non-quarantined set and take ``local_batch_size`` (or
all remaining, when -1) items from each client; the epoch ends when every
client is exhausted. The global ``np.random`` is drawn in the same calls
and order as the JAX sampler, so the same seed gives the same cohorts.

The participation layer (``federated/participation.py``):

- ``participation`` caps the cohort at a subset of the ``num_workers``
  slots (the loader pads the rest with zero masks); ``sampling`` picks
  the draw: ``uniform`` (``np.random.choice``, the draw of full
  participation), ``weighted`` (probability proportional to the remaining
  items) or ``stratified`` (the alive clients split into strata by
  remaining items, one uniform pick a stratum). The others draw
  differently only when they have a choice (a cohort smaller than the
  alive set).
- ``requeue`` returns a dropped client's items to the epoch (its cursor
  rolls back), at most ``retry_limit`` times a client an epoch, after
  which the drop is abandoned.
- ``quarantine`` excludes a client from all later draws of the run.

Population churn (``--churn``, ``federated/participation.PopulationManager``):
with ``_population`` set, each cohort draw steps the churn clock once and
only the live population can be sampled; an empty live population with
joiners still holding data spins the clock (at most ``MAX_IDLE_SPIN``
rounds, then the run raises), and a cohort that churn leaves short of the
participation target is clamped and counted. Churn draws from its own
``RandomState``; the cohort draws keep the global stream, so a run without
churn draws exactly as before.

``get_state`` / ``set_state`` are the checkpoint seam: the JAX keys
``permuted``, ``cursor``, ``retry`` and ``quarantined``; a state without
the last two (an older file) restores with the zero init.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FedSampler"]


class FedSampler:
    def __init__(self, dataset, num_workers, local_batch_size,
                 participation=None, sampling="uniform", retry_limit=3):
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        # read each round, so attach_participation can configure a sampler
        # the loader already built
        self.participation = participation  # cohort target, or None: all
        self.sampling = sampling
        self.retry_limit = int(retry_limit)
        n = int(dataset.num_clients)
        self._retry = np.zeros(n, np.int64)       # requeues this epoch
        self._quarantined = np.zeros(n, bool)      # excluded for the run
        # the open-world population (PopulationManager); None: closed
        self._population = None
        self.requeues = 0
        self.abandoned = 0
        self._permuted = None   # active epoch's within-client permutation
        self._cursor = None     # active epoch's per-client consumption
        self._pending_state = None

    def _draw_cohort(self, alive, n, remaining):
        """One round's cohort of ``n`` clients from ``alive``; the uniform
        branch is the draw of full participation (same call, same stream
        consumption)."""
        if self.sampling != "uniform" and n < len(alive):
            rem = remaining.astype(np.float64)
            if self.sampling == "weighted":
                return np.random.choice(alive, n, replace=False,
                                        p=rem / rem.sum())
            # stratified: ordered by remaining items (stable: ties by id),
            # n strata, one uniform pick a stratum
            order = alive[np.argsort(rem, kind="stable")]
            strata = np.array_split(order, n)
            return np.asarray(
                [s[np.random.randint(len(s))] for s in strata], np.int64)
        return np.random.choice(alive, n, replace=False)

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
            # retry budgets are per epoch; quarantine lasts the run
            self._retry[:] = 0
        self._permuted, self._cursor = permuted, cursor
        pop = self._population
        while True:
            has_data = (cursor < data_per_client) & ~self._quarantined
            if pop is None:
                alive = np.where(has_data)[0]
            else:
                # one churn step a cohort draw; only the live population
                # can be sampled
                pop.step()
                alive = np.where(has_data & pop.live)[0]
                spins = 0
                while (len(alive) == 0
                       and np.any(has_data & pop.joinable())):
                    # empty for now, but joiners still hold data: spin the
                    # churn clock, bounded so a bad schedule fails loudly
                    spins += 1
                    if spins > pop.MAX_IDLE_SPIN:
                        raise RuntimeError(
                            f"--churn: live population stayed empty for "
                            f"{spins} churn rounds with joiners still "
                            f"pending — join rate too low to ever refill "
                            f"the pool?")
                    pop.step(idle=True)
                    alive = np.where(has_data & pop.live)[0]
            if len(alive) == 0:
                return
            target = (self.num_workers if self.participation is None
                      else min(int(self.participation), self.num_workers))
            n = min(target, len(alive))
            if (pop is not None and self.participation is not None
                    and n < target and np.any(has_data & ~pop.live)):
                # churn, not the epoch's end, left the pool short of the
                # target: the cohort is clamped and the shortfall counted
                pop.note_cohort_short(target, n)
            workers = self._draw_cohort(
                alive, n, data_per_client[alive] - cursor[alive])
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

    # -- the participation layer's bookkeeping --------------------------------

    def requeue(self, client_ids, counts):
        """Return dropped clients' just-consumed items to the epoch (each
        cursor rolls back by its count, so the same permutation positions
        serve again), at most ``retry_limit`` times a client an epoch;
        past that the drop is abandoned. Returns ``(requeued, abandoned,
        attempts)``, ``attempts`` each requeued client's retry ordinal.
        Mutates the live epoch's cursor: the caller requeues before the
        next round is drawn (``--train_dataloader_workers 0``)."""
        requeued = abandoned = 0
        attempts = []
        if self._cursor is None:
            return 0, 0, []
        for c, k in zip(np.asarray(client_ids), np.asarray(counts)):
            c, k = int(c), int(round(float(k)))
            if k <= 0:
                continue
            if self._retry[c] >= self.retry_limit:
                abandoned += 1
                self.abandoned += 1
                continue
            self._retry[c] += 1
            attempts.append(int(self._retry[c]))
            self._cursor[c] = max(int(self._cursor[c]) - k, 0)
            requeued += 1
            self.requeues += 1
        return requeued, abandoned, attempts

    def quarantine(self, client_id) -> None:
        """Exclude a client from every later draw of the run."""
        self._quarantined[int(client_id)] = True

    @property
    def quarantined_clients(self) -> np.ndarray:
        return np.where(self._quarantined)[0]

    # -- checkpoint seam ---------------------------------------------------

    def get_state(self):
        """Position of the active epoch (None before the first round) and
        the participation bookkeeping: everything a mid-epoch
        ``set_state`` needs besides the global numpy RNG state."""
        if self._permuted is None:
            return None
        return {"permuted": self._permuted.copy(),
                "cursor": self._cursor.copy(),
                "retry": self._retry.copy(),
                "quarantined": self._quarantined.copy()}

    def set_state(self, state) -> None:
        """Arm a restored mid-epoch position: the NEXT ``iter_structured``
        continues that epoch from the saved cursors. The retry and
        quarantine state restore now; a state without them keeps the zero
        init."""
        self._pending_state = {"permuted": np.asarray(state["permuted"]),
                               "cursor": np.asarray(state["cursor"])}
        if "retry" in state:
            self._retry = np.asarray(state["retry"], np.int64).copy()
        if "quarantined" in state:
            self._quarantined = np.asarray(state["quarantined"],
                                           bool).copy()
