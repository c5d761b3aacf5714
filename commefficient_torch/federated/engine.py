"""Pipelined round engine: federated rounds with no host wait between
drains, the port of ``commefficient_tpu/federated/engine.py``.

The reference loop ``lr_scheduler.step(); loss, ... = model(batch);
opt.step()`` fetches every round's metrics before the next round may be
dispatched. Round t+1 needs round t's device tensors (weights, server
and client state), never its fetched values, so the engine:

- ``submit(batch)`` dispatches one round (LR step, client phase, server
  phase) and keeps its metrics and download count on the device in a
  ``RoundHandle`` (``FedModel.begin_round``; ``seal_round`` records a
  CUDA event after the server phase);
- drains the dispatched rounds every ``drain_every`` submits (or on
  ``drain()`` / ``close()``) with one batched fetch
  (``FedModel.finish_rounds``: the pending rounds' metrics and download
  counts are stacked and copied once, through the counted
  ``profiling.materialize``). The drained values equal per-round
  fetching, bit for bit;
- bounds the host's run-ahead to ``window`` rounds: before it returns from
  the submit of round t it waits for the event of round ``t - window``
  (``torch.cuda.Event.synchronize``, a completion wait, not a transfer;
  nothing to wait for on the CPU).

The engine also drives the observability plane when the model has one
(``telemetry.attach_run_telemetry``): the recorder's spans (``on_dispatch``
with the window's occupancy after the seal, ``on_complete`` when the
window's event wait for a round returns, ``on_drained`` writing each
drained round's line), the round tracer (``on_submit`` before a dispatch,
``on_drained`` after a drain, with a ``trace_captured`` event), the
heartbeat with the round's mean loss and guard verdict (and, under
``--async_buffer``, the buffer's depth and its oldest contribution's
age), and one ``drain``
event a drain. The per-round host work of a drain runs in dispatch order
inside ``FedModel.finish_rounds`` (``on_round``), after that round's
guard ladder, as the JAX package orders it.

Between drains a submit neither fetches nor waits on the stream:
``profiling.host_sync_monitor`` counts zero fetches, and on the card
``host_sync_monitor(strict=True)`` (``torch.cuda.set_sync_debug_mode(
"error")``) raises on any synchronizing call.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, List, NamedTuple, Tuple

import numpy as np

from commefficient_torch.profiling import Heartbeat, annotate

__all__ = ["RoundResult", "PipelinedRoundEngine", "cohort_lookahead"]


def cohort_lookahead(loader, model):
    """The loader's batches unchanged, each next batch drawn only after the
    caller's loop body for the current one has run (``engine.submit``),
    and handed to ``model.prefetch_cohort`` (where the model has one)
    before it is yielded. The sampler's and the augmentation's draws from
    the global ``np.random`` therefore happen in the order of a plain
    ``for batch in loader`` loop, and a run state saved after round t's
    submit records exactly the draws of rounds up to t."""
    it = iter(loader)
    prefetch = getattr(model, "prefetch_cohort", None)
    try:
        batch = next(it)
    except StopIteration:
        return
    while True:
        yield batch
        try:
            nxt = next(it)
        except StopIteration:
            return
        if prefetch is not None:
            prefetch(nxt)
        batch = nxt


class RoundResult(NamedTuple):
    """One finished round: ``index`` is the submit order (0-based within
    the engine's lifetime), ``values`` the result list ``[loss_arr,
    *metric_arrs, download_bytes, upload_bytes]`` that ``model(batch)``
    returns (the CV losses have one metric, accuracy; GPT-2's train loss
    none)."""

    index: int
    values: List[Any]


class PipelinedRoundEngine:
    """Drives ``FedModel`` + ``FedOptimizer`` (+ an optional LR
    scheduler) with round pipelining and batched metric drains.

    ``submit(batch)`` replaces the loop body ``lr_scheduler.step();
    model(batch); opt.step()`` and returns the rounds drained by this
    call: empty on most rounds, ``drain_every`` results on a drain round,
    always in submit order. Call ``drain()`` after the loop and before a
    run-state save. ``drain_every=1`` fetches every round, as the
    reference loop does."""

    def __init__(self, model, opt, lr_scheduler=None, window: int = 2,
                 drain_every: int = 8):
        assert window >= 1, "in-flight window must be at least 1"
        assert drain_every >= 1, "drain_every must be at least 1"
        self.model = model
        self.opt = opt
        self.lr_scheduler = lr_scheduler
        self.window = window
        self.drain_every = drain_every
        self._pending: Deque[Tuple[int, Any]] = deque()
        self._next_index = 0
        self.drains = 0
        self.window_waits = 0
        # the model's recorder and round tracer (attach_run_telemetry)
        self.telemetry = getattr(model, "telemetry", None)
        self.heartbeat = Heartbeat()
        self.tracer = getattr(model, "tracer", None)

    def submit(self, batch) -> List[RoundResult]:
        """Dispatch one training round; nothing is fetched here unless
        this is a drain round (every ``drain_every``-th)."""
        t_start = time.monotonic()
        if self.tracer is not None:
            # may start a capture before the dispatch, so the round is in it
            self.tracer.on_submit(getattr(self.model, "rounds_dispatched",
                                          self._next_index))
        with annotate("fed_round"):
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
            handle = self.model.begin_round(batch)
            self.opt.step()
            seal = getattr(self.model, "seal_round", None)
            if seal is not None:
                handle = seal(handle)
        self._pending.append((self._next_index, handle))
        self._next_index += 1
        if self.telemetry is not None:
            self.telemetry.on_dispatch(
                self._round_no(handle, self._next_index - 1), t_start,
                occupancy=len(self._pending))

        if len(self._pending) > self.window:
            # bound the host's run-ahead: wait for the completion of the
            # round `window` back; its values stay on the device
            oidx, old = self._pending[-1 - self.window]
            done = getattr(old, "done", None)
            if done is not None:
                done.synchronize()
                self.window_waits += 1
            if self.telemetry is not None:
                self.telemetry.on_complete(self._round_no(old, oidx))

        if len(self._pending) >= self.drain_every:
            return self.drain()
        return []

    @staticmethod
    def _round_no(handle, fallback: int) -> int:
        rn = getattr(handle, "round_no", -1)
        return rn if rn >= 0 else fallback

    def drain(self) -> List[RoundResult]:
        """Fetch every dispatched round, oldest first, with one batched
        fetch. Safe to call with nothing pending."""
        if not self._pending:
            return []
        items = list(self._pending)
        self._pending.clear()
        order = iter(items)
        t0 = t_last = time.monotonic()

        def on_round(handle, values):
            """One drained round's host work, in dispatch order."""
            nonlocal t_last
            rn = self._round_no(handle, next(order)[0])
            if self.heartbeat.enabled:
                loss = values[0]
                # --async_buffer: the buffer's depth and its oldest
                # contribution's age (absent on the synchronous path)
                buf = stale = None
                part = getattr(self.model, "_participation", None)
                if part is not None and part.async_k:
                    buf = len(part.buffer)
                    stale = part.oldest_age(getattr(
                        self.model, "rounds_dispatched", self._next_index))
                # --churn: the live population (absent for a closed one)
                pop = getattr(self.model, "_population", None)
                self.heartbeat.round(
                    rn, loss=float(np.mean(loss)) if np.size(loss) else None,
                    guard_ok=getattr(self.model, "last_guard_ok", None),
                    buffer=buf, stale=stale,
                    population=pop.population if pop is not None else None)
            now = time.monotonic()
            if self.telemetry is not None:
                self.telemetry.on_drained(rn, now - t_last)
            t_last = now
            if self.tracer is not None:
                cap = self.tracer.on_drained(rn)
                if cap is not None and self.telemetry is not None:
                    self.telemetry.event("trace_captured", **cap)

        with annotate("fed_drain"):
            values = self.model.finish_rounds([h for _, h in items],
                                              on_round=on_round)
        results = [RoundResult(idx, v) for (idx, _), v in zip(items, values)]
        self.drains += 1
        if self.telemetry is not None:
            self.telemetry.event("drain", rounds=len(results),
                                 ms=round((time.monotonic() - t0) * 1e3, 3))
        return results

    def close(self) -> List[RoundResult]:
        """Final drain: fetch every in-flight round and return the
        results."""
        return self.drain()

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def rounds_submitted(self) -> int:
        """Rounds submitted over the engine's lifetime (the next round's
        ``RoundResult.index``)."""
        return self._next_index
