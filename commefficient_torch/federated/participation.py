"""Client participation, stragglers and async buffered federation: the
port of ``commefficient_tpu/federated/participation.py`` (its lines up to
``attach_participation``; population churn, ``--churn``, is ROADMAP
queue 1 item 6e and stays unported).

Three mechanisms, as in the JAX package:

1. **Partial participation** (``--participation <frac|count>``): the
   ``FedSampler`` draws a per-round cohort subset (``uniform``,
   ``weighted`` by remaining data, or ``stratified`` over remaining-data
   strata; ``--participation_sampling``) and the loader pads the unused
   slots with zero masks. The round aggregate is the data-weighted mean,
   so a missing client is an exact reweighting.
2. **Client faults** (``--inject_client_fault``): a seeded schedule draws
   one uniform a slot a round from its own ``numpy.random.RandomState``
   (the JAX package's stream, so both draw the same pattern bit for bit)
   and classifies each live slot as healthy, drop (masked out; its items
   return to the sampler, ``FedSampler.requeue``, bounded by
   ``--client_retry_limit``), slow (masked out of round t; its client
   phase still runs at round t against w_t and the un-normalized transmit
   sum is held on the device until round t + delay) or corrupt (masked
   out before the round sum; a client caught ``quarantine_after`` times
   leaves the sampling pool, ``FedSampler.quarantine``).
3. **Staleness-weighted late landing**: a straggler cohort folds into
   round t' = t + Δ with w(Δ) = ``--staleness_decay`` ** Δ,
   ``g = (S_now + w S_late) / (C_now + w C_late)``. On the replicated
   plane the client phase emits the normalized mean, so the fold
   un-normalizes first (``_transmit_sum``); under ``--server_shard`` the
   rank's unreduced sum and the round's count are folded (``_fold_sum``
   plus the count) and the server reduces.
4. **Async buffered federation** (``--async_buffer K``): every
   contribution is a landing. A dispatch either folds (the buffer plus
   this dispatch reach K; the dispatch is the fold base and gets the
   client-state scatter) or is buffered and skips the server phase. Each
   contribution carries the server version it read, so its staleness at
   the fold is exact, and a per-contribution finiteness verdict (a device
   bool) masks a poisoned contribution out of its fold by a select.

A straggler's late landing folds the TRANSMIT only: per-client velocity,
error and stale-weight rows do not advance for a straggler cohort (their
slots are masked at dispatch, so the scatter leaves their rows as they
were). The same holds for buffered async dispatches.

The fold helpers are plain PyTorch on tensors already on the device; the
weights and counts enter as Python floats (float32 values computed on the
host, as the JAX package computes them) or 0-d device tensors, and none
of them reads a device value on the host. Under ``--server_shard`` the
finiteness verdict of a held partial sum is AND-ed over the client group
(one all-reduce on the device), so every rank folds the same
contributions.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "SAMPLING_CHOICES",
    "AsyncContribution",
    "FaultSchedule",
    "LateCohort",
    "ParticipationController",
    "attach_participation",
    "expire_participation",
    "parse_client_fault",
    "parse_participation",
    "staleness_weight",
]

SAMPLING_CHOICES = ("uniform", "weighted", "stratified")


def parse_participation(spec, num_workers: int) -> Optional[int]:
    """``--participation`` spec -> the per-round cohort target (clients):
    a value in (0, 1] is a fraction of ``num_workers`` (ceil, at least 1),
    a value above 1 an integral count of at most ``num_workers``; empty or
    None is full participation (None). A malformed spec raises
    ``ValueError`` here."""
    if spec in (None, ""):
        return None
    s = str(spec).strip()
    try:
        val = float(s)
    except ValueError:
        raise ValueError(
            f"--participation: {spec!r} is not a fraction in (0, 1] or a "
            f"client count") from None
    if val <= 0:
        raise ValueError(f"--participation: {spec!r} must be > 0")
    if val <= 1.0:
        return max(1, int(math.ceil(val * num_workers)))
    if val != int(val):
        raise ValueError(
            f"--participation: counts must be integral (got {spec!r}); "
            f"use a fraction in (0, 1] for proportional cohorts")
    n = int(val)
    if n > num_workers:
        raise ValueError(
            f"--participation: count {n} exceeds --num_workers "
            f"{num_workers} (the cohort is drawn from the round's worker "
            f"slots)")
    return n


@dataclass(frozen=True)
class FaultSchedule:
    """The seeded client-fault schedule (``--inject_client_fault``): each
    live slot draws one uniform a round; u < drop drops, u < drop + slow
    straggles, u < drop + slow + corrupt is corrupt. ``delay`` is the
    straggler's landing delay in rounds, ``quarantine_after`` the corrupt
    count that quarantines a client."""

    drop: float = 0.0
    slow: float = 0.0
    corrupt: float = 0.0
    delay: int = 2
    seed: int = 0
    quarantine_after: int = 3

    @property
    def active(self) -> bool:
        return bool(self.drop or self.slow or self.corrupt)

    def spec(self) -> str:
        return (f"drop={self.drop:g},slow={self.slow:g},"
                f"corrupt={self.corrupt:g},delay={self.delay},"
                f"seed={self.seed},quarantine_after={self.quarantine_after}")


def parse_client_fault(spec: str) -> FaultSchedule:
    """``'drop=P,slow=P,corrupt=P,delay=N,seed=N,quarantine_after=N'`` ->
    ``FaultSchedule``; every key optional, at least one probability > 0,
    drop + slow + corrupt < 1. An unknown key or a malformed entry raises
    ``ValueError``, a value out of range ``AssertionError`` (the JAX
    package's exceptions)."""
    fields: Dict[str, Any] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            key, val = (x.strip() for x in part.split("="))
        except ValueError:
            raise ValueError(
                f"--inject_client_fault: bad entry {part!r}; expected "
                f"KEY=VALUE with KEY in drop|slow|corrupt|delay|seed|"
                f"quarantine_after") from None
        if key in ("drop", "slow", "corrupt"):
            p = float(val)
            assert 0.0 <= p < 1.0, (
                f"--inject_client_fault: {key}={val} must be in [0, 1)")
            fields[key] = p
        elif key in ("delay", "seed", "quarantine_after"):
            fields[key] = int(val)
        else:
            raise ValueError(
                f"--inject_client_fault: unknown key {key!r}; use "
                f"drop|slow|corrupt|delay|seed|quarantine_after")
    sched = FaultSchedule(**fields)
    assert sched.active, (
        "--inject_client_fault: at least one of drop/slow/corrupt must "
        "be > 0")
    assert sched.drop + sched.slow + sched.corrupt < 1.0, (
        "--inject_client_fault: drop+slow+corrupt must be < 1 (a round "
        "needs room for healthy slots)")
    assert sched.delay >= 1, (
        "--inject_client_fault: delay must be >= 1 round (a delay-0 "
        "straggler is an on-time client)")
    assert sched.quarantine_after >= 1, (
        "--inject_client_fault: quarantine_after must be >= 1")
    return sched


def staleness_weight(delay: int, decay: float) -> float:
    """w(Δ) = decay ** Δ, the late-landing weight of a contribution Δ
    rounds (or, async, Δ server folds) stale."""
    return float(decay) ** int(delay)


class LateCohort(NamedTuple):
    """A straggler cohort in flight: its un-normalized transmit sum (a
    device tensor; under ``--server_shard`` this rank's partial sum), its
    datum count (host float), its client ids, and its dispatch and due
    rounds (global round indices). ``version_read``: the server version it
    sampled (async only; -1 on the synchronous path)."""

    transmit_sum: Any
    count: float
    ids: np.ndarray
    dispatch_round: int
    due_round: int
    version_read: int = -1


class AsyncContribution(NamedTuple):
    """A landed, unfolded contribution of the async buffer: the transmit
    sum (device), its datum count (host float), the client ids, the
    server version it read, the dispatch round, and ``ok``, its finiteness
    verdict (a 0-d device bool)."""

    transmit_sum: Any
    count: float
    ids: np.ndarray
    version_read: int
    dispatch_round: int
    ok: Any


def _f32(x) -> float:
    """A host scalar rounded to float32, as a Python float (exact)."""
    return float(np.float32(x))


def _transmit_sum(grad_mean, count):
    """Replicated plane: the client phase's data-weighted mean back to the
    transmit sum (sums fold linearly)."""
    return grad_mean * count


def _fold_mean(grad_mean, count, late_sum, late_weighted_count, weight):
    """(S_now + w S_late) / (C_now + w C_late), with grad_mean = S_now /
    C_now; the denominator is a float32 add on the host, as JAX adds its
    two float32 scalars."""
    den = _f32(np.float32(count) + np.float32(late_weighted_count))
    return (grad_mean * count + weight * late_sum) / den


def _fold_sum(grad_sum, late_sum, weight):
    """Sharded plane: the rank's partial sums fold by a scaled add (the
    division happens after the server's reduce)."""
    return grad_sum + weight * late_sum


def _finite_ok(x, group=None):
    """True iff every element of the held sum is finite: a 0-d device
    bool. Under ``--server_shard`` (``group``), AND-ed over the ranks
    with one all-reduce on the device."""
    ok = torch.isfinite(x).all()
    if group is not None:
        import torch.distributed as dist

        flag = ok.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group.group)
        ok = flag[0] > 0
    return ok


def _masked_fold(acc_sum, c_sum, weight, ok):
    """acc + w * contribution, the contribution selected to zero when its
    verdict failed (a select: a NaN never reaches the accumulator)."""
    safe = torch.where(ok, c_sum, torch.zeros_like(c_sum))
    return acc_sum + weight * safe


def _masked_count(acc_count, c_weighted_count, ok):
    """The denominator twin of ``_masked_fold``: the (w-scaled) count joins
    only when the verdict passed."""
    return acc_count + ok.to(torch.float32) * c_weighted_count


def _count_masked(acc, ok):
    miss = 1.0 - ok.to(torch.float32)
    return miss if acc is None else acc + miss


def _safe_mean(num, den):
    """num / den with an all-masked fold giving a zero update (den clamped
    to at least 1) instead of 0/0."""
    return num / torch.clamp(den, min=1.0)


class ParticipationController:
    """Host-side orchestration of client faults, late landing and the
    async buffer, owned by ``FedModel`` (``attach_participation``). Its
    work is numpy on the host and the fold helpers on tensors already on
    the device: no host sync."""

    def __init__(self, schedule: Optional[FaultSchedule] = None,
                 decay: float = 0.5, sampler=None,
                 target: Optional[int] = None, async_k: int = 0,
                 group=None):
        self.schedule = schedule
        self.decay = float(decay)
        self.sampler = sampler
        self.target = target
        # the client group whose ranks hold partial sums (--server_shard)
        self.group = group
        seed = schedule.seed if schedule is not None else 0
        self.rng = np.random.RandomState(seed)
        self.pending: List[LateCohort] = []
        self.drops = 0
        self.slows = 0
        self.corrupts = 0
        self.landed = 0
        self.expired = 0
        self.requeued = 0
        self.abandoned = 0
        self.fault_skips = 0
        self._corrupt_counts: Dict[int, int] = {}
        # the quarantine ledger also lives here: an epoch-boundary run
        # state carries no sampler state
        self._quarantined_clients: set = set()
        # async: server_version counts folds; the conservation invariant
        # contributions == folded + len(buffer) + len(pending) (+ the
        # expired after the end-of-run audit) holds
        self.async_k = int(async_k)
        self.server_version = 0
        self.buffer: List[AsyncContribution] = []
        self.contributions = 0
        self.folded = 0
        self.folds = 0
        self.masked = 0
        self.async_expired = 0

    @property
    def quarantined(self) -> int:
        return len(self._quarantined_clients)

    # -- fault application (FedModel.begin_round) ---------------------------

    def apply_faults(self, batch: dict, round_no: int
                     ) -> Tuple[dict, Optional[dict], dict]:
        """Classify this round's live slots and split the batch into
        ``(primary_batch, late_batch or None, cohort_info)``: the primary
        batch keeps the on-time slots (the faulted ones zero-masked), the
        late batch only the stragglers; ``cohort_info`` goes to the
        telemetry ``cohort`` span. Host data only."""
        info: Dict[str, Any] = {}
        if self.target is not None:
            info["target"] = int(self.target)
        sched = self.schedule
        if sched is None or not sched.active:
            return batch, None, info
        wmask = np.asarray(batch["worker_mask"])
        live = wmask > 0
        # one draw per slot, padded slots included, so the schedule does
        # not depend on how many slots the sampler filled
        draws = self.rng.random_sample(wmask.shape)
        drop = live & (draws < sched.drop)
        slow = live & ~drop & (draws < sched.drop + sched.slow)
        corrupt = live & ~drop & ~slow \
            & (draws < sched.drop + sched.slow + sched.corrupt)
        faulted = drop | slow | corrupt
        if live.any() and faulted[live].all():
            # no on-time and no late contribution: keep the full cohort
            self.fault_skips += 1
            info["fault_skip"] = True
            return batch, None, info

        ids = np.asarray(batch["client_ids"])
        mask = np.asarray(batch["mask"])
        slot_counts = mask.reshape(mask.shape[0], -1).sum(axis=1)

        def _masked(keep):
            out = dict(batch)
            wm = np.where(keep, wmask, 0.0).astype(np.float32)
            out["worker_mask"] = wm
            out["mask"] = (mask * wm.reshape(
                wm.shape + (1,) * (mask.ndim - 1))).astype(mask.dtype)
            return out

        primary = _masked(live & ~faulted)
        late_batch = _masked(slow) if slow.any() else None

        if drop.any():
            n_drop = int(drop.sum())
            self.drops += n_drop
            info["dropped"] = n_drop
            if self.sampler is not None:
                req, aband, attempts = self.sampler.requeue(
                    ids[drop], slot_counts[drop])
                self.requeued += req
                self.abandoned += aband
                if req:
                    info["requeued"] = req
                if aband:
                    info["abandoned"] = aband
                if attempts:
                    info["retry_attempts"] = attempts
        if slow.any():
            n_slow = int(slow.sum())
            self.slows += n_slow
            info["slow"] = n_slow
        if corrupt.any():
            n_cor = int(corrupt.sum())
            self.corrupts += n_cor
            info["corrupt"] = n_cor
            quarantined_now = []
            for c in np.unique(ids[corrupt]):
                c = int(c)
                n = self._corrupt_counts.get(c, 0) + 1
                self._corrupt_counts[c] = n
                # >=: a restored count already past the threshold still
                # quarantines at the next offense
                if (n >= sched.quarantine_after
                        and c not in self._quarantined_clients):
                    self._quarantined_clients.add(c)
                    quarantined_now.append(c)
                    if self.sampler is not None:
                        self.sampler.quarantine(c)
            if quarantined_now:
                info["quarantined_now"] = quarantined_now
        if self.quarantined:
            info["quarantined_total"] = self.quarantined
        return primary, late_batch, info

    # -- the straggler buffer -------------------------------------------------

    def hold(self, transmit_sum, count: float, ids, round_no: int) -> None:
        """Park a straggler cohort's transmit sum (it stays referenced on
        the device) until its due round."""
        assert self.schedule is not None
        self.pending.append(LateCohort(
            transmit_sum=transmit_sum, count=float(count),
            ids=np.asarray(ids, np.int64),
            dispatch_round=int(round_no),
            due_round=int(round_no) + int(self.schedule.delay),
            version_read=(self.server_version if self.async_k else -1)))
        if self.async_k:
            self.contributions += 1

    def fold_due(self, ctx, round_no: int, sharded: bool, count: float
                 ) -> Tuple[Any, List[dict]]:
        """Fold every due straggler cohort into this round's aggregate with
        w(Δ) = decay ** Δ. ``count``: the primary batch's datum count (host
        float). Returns the updated ctx and the landing records."""
        landed: List[dict] = []
        due = [c for c in self.pending if c.due_round <= round_no]
        if not due:
            return ctx, landed
        self.pending = [c for c in self.pending if c.due_round > round_no]
        for coh in due:
            delay = round_no - coh.dispatch_round
            w = staleness_weight(delay, self.decay)
            if sharded:
                ctx = ctx._replace(
                    gradient=_fold_sum(ctx.gradient, coh.transmit_sum,
                                       _f32(w)),
                    count=ctx.count + _f32(w * coh.count))
            else:
                ctx = ctx._replace(gradient=_fold_mean(
                    ctx.gradient, _f32(count), coh.transmit_sum,
                    _f32(w * coh.count), _f32(w)))
                count = count + w * coh.count
            self.landed += 1
            landed.append({"from_round": coh.dispatch_round,
                           "delay": int(delay), "weight": round(w, 6),
                           "count": coh.count,
                           "clients": [int(c) for c in coh.ids]})
        return ctx, landed

    def expire_pending(self) -> int:
        """Discard the stragglers whose due round will never dispatch (run
        end); counted."""
        n = len(self.pending)
        self.pending = []
        self.expired += n
        return n

    # -- async buffered federation ------------------------------------------

    def async_step(self, ctx, round_no: int, sharded: bool, count: float,
                   ids=None) -> Tuple[Any, bool, Dict[str, Any]]:
        """One dispatch on the async plane: the due stragglers land in the
        buffer; then this dispatch folds (buffer + 1 >= K: the server phase
        runs on the folded ctx) or is buffered (the server phase is
        skipped). Returns ``(ctx, fold, info)``; on a fold ``info`` holds
        the device count of masked contributions under ``"masked_dev"``."""
        assert self.async_k >= 1
        due = [c for c in self.pending if c.due_round <= round_no]
        if due:
            self.pending = [c for c in self.pending
                            if c.due_round > round_no]
            for coh in due:
                self.landed += 1
                self.buffer.append(AsyncContribution(
                    transmit_sum=coh.transmit_sum, count=coh.count,
                    ids=coh.ids,
                    version_read=(coh.version_read
                                  if coh.version_read >= 0
                                  else self.server_version),
                    dispatch_round=coh.dispatch_round,
                    ok=_finite_ok(coh.transmit_sum, self.group)))
        self.contributions += 1
        info: Dict[str, Any] = {"version": self.server_version,
                                "depth": len(self.buffer)}

        if len(self.buffer) + 1 < self.async_k:
            transmit = (ctx.gradient if sharded
                        else _transmit_sum(ctx.gradient, _f32(count)))
            self.buffer.append(AsyncContribution(
                transmit_sum=transmit, count=float(count),
                ids=np.asarray(ids if ids is not None else [], np.int64),
                version_read=self.server_version,
                dispatch_round=int(round_no),
                ok=_finite_ok(transmit, self.group)))
            info["depth"] = len(self.buffer)
            return ctx, False, info

        # the fold: this dispatch is the base (weight 1); each buffered
        # contribution folds with w(Δ), Δ exact from its version tag,
        # masked by its verdict
        folds = self.buffer
        self.buffer = []
        staleness: List[dict] = []
        masked_dev = None
        if folds:
            if sharded:
                grad, cnt = ctx.gradient, ctx.count
            else:
                grad = _transmit_sum(ctx.gradient, _f32(count))
                cnt = _f32(count)
            for c in folds:
                delta = self.server_version - c.version_read
                w = staleness_weight(delta, self.decay)
                grad = _masked_fold(grad, c.transmit_sum, _f32(w), c.ok)
                cnt = _masked_count(cnt, _f32(w * c.count), c.ok)
                masked_dev = _count_masked(masked_dev, c.ok)
                self.folded += 1
                staleness.append({"from_round": c.dispatch_round,
                                  "delay": int(delta),
                                  "weight": round(w, 6),
                                  "count": c.count})
            if sharded:
                ctx = ctx._replace(gradient=grad, count=cnt)
            else:
                ctx = ctx._replace(gradient=_safe_mean(grad, cnt))
        self.folded += 1
        self.folds += 1
        self.server_version += 1
        info.update(folded=len(folds) + 1, version=self.server_version)
        if staleness:
            info["staleness"] = staleness
        if masked_dev is not None:
            info["masked_dev"] = masked_dev
        return ctx, True, info

    def note_masked(self, n: int) -> None:
        """Drain-time: ``n`` fold entries' verdicts came back False."""
        self.masked += int(n)

    def expire_buffer(self) -> int:
        """Discard the landed, unfolded contributions at run end;
        counted."""
        n = len(self.buffer)
        self.buffer = []
        self.async_expired += n
        return n

    def oldest_age(self, round_no: int) -> int:
        """Dispatch age in rounds of the oldest unfolded contribution,
        buffered or pending (the heartbeat's ``stale``)."""
        oldest = [c.dispatch_round for c in self.buffer] + \
                 [c.dispatch_round for c in self.pending]
        if not oldest:
            return 0
        return max(0, int(round_no) - min(oldest))

    # -- counters and the run state ------------------------------------------

    def counters(self) -> Dict[str, int]:
        out = {"drops": self.drops, "slows": self.slows,
               "corrupts": self.corrupts, "landed": self.landed,
               "expired": self.expired, "requeued": self.requeued,
               "abandoned": self.abandoned,
               "quarantined": self.quarantined,
               "fault_skips": self.fault_skips,
               "pending": len(self.pending)}
        if self.async_k:
            out.update(contributions=self.contributions,
                       folded=self.folded, folds=self.folds,
                       masked=self.masked,
                       async_expired=self.async_expired,
                       buffered=len(self.buffer),
                       server_version=self.server_version)
        return out

    def state_payload(self, host=None) -> Tuple[Dict[str, np.ndarray], dict]:
        """The run-state half ``(arrays, meta)``, the JAX package's
        ``part/*`` keys and ``participation`` meta: the fault RNG, each
        pending and buffered cohort's held sum and ids, the counters, the
        corrupt and quarantine ledgers, the cohorts' rounds. ``host``
        turns a held device tensor into the array saved (default: a
        counted fetch; a save is a drain point)."""
        from commefficient_torch.profiling import materialize

        host = host or materialize
        arrays: Dict[str, np.ndarray] = {}
        _, keys, pos, has_gauss, cached = self.rng.get_state()
        arrays["rng_keys"] = keys
        arrays["rng_meta"] = np.asarray([pos, has_gauss], np.int64)
        arrays["rng_cached"] = np.asarray([cached], np.float64)
        for i, coh in enumerate(self.pending):
            arrays[f"pending{i}/sum"] = host(coh.transmit_sum)
            arrays[f"pending{i}/ids"] = np.asarray(coh.ids, np.int64)
        meta = {
            "counters": self.counters(),
            "corrupt_counts": {str(k): int(v)
                               for k, v in self._corrupt_counts.items()},
            "quarantined_clients": sorted(self._quarantined_clients),
            "pending": [{"count": c.count,
                         "dispatch_round": c.dispatch_round,
                         "due_round": c.due_round,
                         "version_read": c.version_read}
                        for c in self.pending],
        }
        if self.async_k:
            for i, c in enumerate(self.buffer):
                arrays[f"buffer{i}/sum"] = host(c.transmit_sum)
                arrays[f"buffer{i}/ids"] = np.asarray(c.ids, np.int64)
            meta["async"] = {
                "k": self.async_k,
                "server_version": self.server_version,
                "buffer": [{"count": c.count,
                            "version_read": c.version_read,
                            "dispatch_round": c.dispatch_round}
                           for c in self.buffer],
            }
        return arrays, meta

    def restore_state(self, arrays: Dict[str, np.ndarray], meta: dict,
                      as_device) -> None:
        """The inverse of ``state_payload``; ``as_device`` lifts a saved
        held sum back to a device tensor (a buffered contribution's verdict
        is recomputed from it on the device)."""
        pos, has_gauss = (int(x) for x in arrays["rng_meta"])
        self.rng.set_state(("MT19937", arrays["rng_keys"], pos, has_gauss,
                            float(arrays["rng_cached"][0])))
        ctr = meta.get("counters", {})
        for name in ("drops", "slows", "corrupts", "landed", "expired",
                     "requeued", "abandoned", "fault_skips"):
            setattr(self, name, int(ctr.get(name, 0)))
        self._corrupt_counts = {int(k): int(v) for k, v in
                                meta.get("corrupt_counts", {}).items()}
        self._quarantined_clients = {
            int(c) for c in meta.get("quarantined_clients", [])}
        if self.sampler is not None:
            for c in self._quarantined_clients:
                self.sampler.quarantine(c)
        self.pending = [
            LateCohort(transmit_sum=as_device(arrays[f"pending{i}/sum"]),
                       count=float(p["count"]),
                       ids=np.asarray(arrays[f"pending{i}/ids"], np.int64),
                       dispatch_round=int(p["dispatch_round"]),
                       due_round=int(p["due_round"]),
                       version_read=int(p.get("version_read", -1)))
            for i, p in enumerate(meta.get("pending", []))]
        a_meta = meta.get("async")
        if a_meta is not None and self.async_k:
            self.server_version = int(a_meta.get("server_version", 0))
            self.buffer = []
            for i, b in enumerate(a_meta.get("buffer", [])):
                s = as_device(arrays[f"buffer{i}/sum"])
                self.buffer.append(AsyncContribution(
                    transmit_sum=s, count=float(b["count"]),
                    ids=np.asarray(arrays[f"buffer{i}/ids"], np.int64),
                    version_read=int(b["version_read"]),
                    dispatch_round=int(b["dispatch_round"]),
                    ok=_finite_ok(s, self.group)))
            for name in ("contributions", "folded", "folds", "masked",
                         "async_expired"):
                setattr(self, name, int(ctr.get(name, 0)))
        elif self.async_k:
            warnings.warn(
                "--async_buffer is on but the checkpoint predates the "
                "async plane; the buffer/version timeline restarts empty "
                "at version 0")


def attach_participation(args, fed_model, sampler=None):
    """Entry-point hook (``cv_train`` / ``gpt2_train``, after the loader is
    built): parse ``--participation`` / ``--inject_client_fault`` /
    ``--async_buffer``, set the sampler's cohort target, draw and retry
    limit, and attach a ``ParticipationController`` to the model as
    ``fed_model._participation``. Returns it, or None when no flag is set
    (the model's ``begin_round`` then takes the path without the
    layer)."""
    target = parse_participation(getattr(args, "participation", "") or "",
                                 args.num_workers)
    spec = (getattr(args, "inject_client_fault", "") or "").strip()
    schedule = parse_client_fault(spec) if spec else None
    async_k = int(getattr(args, "async_buffer", 0) or 0)
    if sampler is not None:
        sampler.participation = target
        sampler.sampling = getattr(args, "participation_sampling",
                                   "uniform")
        sampler.retry_limit = int(getattr(args, "client_retry_limit", 3))
    if target is None and schedule is None and not async_k:
        return None
    group = getattr(fed_model, "group", None)
    sharded = group is not None and fed_model.round_config.server_shard
    ctl = ParticipationController(
        schedule=schedule,
        decay=float(getattr(args, "staleness_decay", 0.5)),
        sampler=sampler, target=target, async_k=async_k,
        group=group if sharded else None)
    fed_model._participation = ctl
    parts = []
    if target is not None:
        parts.append(f"cohort target {target}/{args.num_workers} "
                     f"({getattr(args, 'participation_sampling', 'uniform')}"
                     f" sampling)")
    if schedule is not None:
        parts.append(f"client faults {schedule.spec()} "
                     f"(w(Δ)={ctl.decay:g}**Δ late landing)")
    if async_k:
        parts.append(f"async buffer K={async_k} "
                     f"(fold on K landed contributions, exact-version "
                     f"staleness)")
    print("participation layer: " + "; ".join(parts))
    return ctl


def expire_participation(pc, rt) -> None:
    """The end-of-run expiry audit: stragglers whose due round will never
    dispatch and async contributions that never reached a fold are
    counted, with ``straggler_expired`` / ``async_expired`` events."""
    if pc is None:
        return
    expired = pc.expire_pending()
    if expired and rt is not None:
        rt.event("straggler_expired", count=expired)
    a_expired = pc.expire_buffer() if pc.async_k else 0
    if a_expired and rt is not None:
        rt.event("async_expired", count=a_expired)
