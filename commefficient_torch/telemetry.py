"""The observability plane: on-device round metrics, the run event log,
round-lifecycle spans and the watch rules. The port of
``commefficient_tpu/telemetry.py`` (its own copy; nothing of the JAX
package is imported).

Three layers, none of which adds a host sync to a round:

1. **On-device metrics** (``device_round_metrics``): one fixed-schema
   float32 vector a round, computed inside the server phase
   (``rounds.server_step`` under ``RoundConfig.telemetry``) after the
   guard select: norms of the transmit the server consumed, of the
   lr-scaled update and of the post-round carries, the resolved top-k
   threshold, the guard verdict and (schema v3) log-magnitude histograms
   of the update and the error carry. Plain PyTorch reductions that feed
   nothing back, so trajectories are bit-identical with telemetry on and
   off. The vector rides the round handle (``FedModel.seal_round``) and
   is fetched with the losses in the drain's one counted ``materialize``.
   Under ``--server_shard`` each rank holds a piece of the transmit and
   of the carries; one all-gather of a few float64 partials a round
   (sums of squares, the transmit's largest magnitude, histogram counts)
   makes every rank's vector the one JAX computes on the global arrays.
2. **Host-side spans** (``RunTelemetry``): dispatch, seal, the window's
   completion wait and the drain, buffered per round and written when
   the round drains.
3. **The JSONL event log** (``<run_dir>/telemetry.jsonl``): the JAX
   package's event kinds and fields, which ``scripts/obs_report.py``
   renders.

``WatchEngine`` evaluates declarative threshold and EWMA-drift rules over
each drained round record (host arithmetic on fetched values) with the
JAX package's log / trace / checkpoint reactions; ``collective_ledger``
prices the flat wire legs once for the ``run_start`` event.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import (
    Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple,
)

import torch
import torch.distributed as dist

__all__ = [
    "METRIC_FIELDS",
    "N_SCALAR_FIELDS",
    "HIST_BINS",
    "HIST_LO",
    "HIST_STEP",
    "metric_schema",
    "log_magnitude_histogram",
    "device_round_metrics",
    "collective_ledger",
    "RunTelemetry",
    "attach_run_telemetry",
    "close_run_telemetry",
    "watch_can_checkpoint",
    "take_watch_checkpoint",
    "read_events",
    "WatchRule",
    "WatchEngine",
    "parse_watch_rules",
    "DEFAULT_WATCH_RULES",
]

# The fixed schema, in the JAX package's stack order (its telemetry.py
# documents each field). Fields that do not apply to a config are 0.0.
HIST_BINS = 8
HIST_LO = -12.0   # log10 of the first finite bin's lower edge
HIST_STEP = 2.0   # decades per bin: bins span 1e-12 .. 1e4
METRIC_FIELDS = (
    "transmit_norm",
    "transmit_max_abs",
    "update_norm",
    "update_nnz",
    "topk_threshold",
    "velocity_norm",
    "error_norm",
    "qres_norm",
    "ps_norm",
    "ps_max_abs",
    "guard_ok",
    "dres_norm",
) + tuple(f"update_hist_{i}" for i in range(HIST_BINS)) \
  + tuple(f"error_hist_{i}" for i in range(HIST_BINS))

# the scalar prefix: schema v2, and the vector without histograms
N_SCALAR_FIELDS = 12

_INF = float("inf")


def metric_schema(hists: bool = True) -> Tuple[str, ...]:
    """The active metric schema: the full v3 tuple with the histogram
    block, the 12-field v2 prefix without."""
    return METRIC_FIELDS if hists else METRIC_FIELDS[:N_SCALAR_FIELDS]


# elements a histc call counts: below 2^24 its float32 counts are exact
_HIST_CHUNK = 1 << 24


def _hist_counts(x: torch.Tensor, ax: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The ``(HIST_BINS,)`` int64 counts of ``log_magnitude_histogram``.

    The JAX package's bin of a nonzero ``|x|`` is ``clip(floor((log10|x|
    - HIST_LO) / HIST_STEP), 0, HIST_BINS - 1)``, non-finite values in the
    last bin, zeros excluded. Here ``t = log10|x| - HIST_LO`` (the same
    float32 subtraction); NaN and inf become a value of the last bin and
    zeros (``-inf``) NaN, before anything is cast; ``t`` is clamped into
    ``[0, HIST_BINS * HIST_STEP)``; and ``torch.histc`` over that range
    in ``HIST_BINS`` bins takes ``floor(t / HIST_STEP)`` (a power-of-two
    scaling, exact) and skips the NaNs. Each ``histc`` counts at most
    2^24 elements, so its float32 counts are exact, and the counts add up
    in int64: a bin stays exact above 2^24."""
    ax = x.detach().reshape(-1).to(torch.float32).abs() if ax is None \
        else ax.reshape(-1)
    top = HIST_BINS * HIST_STEP
    last = top - HIST_STEP / 2
    t = torch.log10(ax)
    t.sub_(HIST_LO).nan_to_num_(nan=last, posinf=last, neginf=float("nan"))
    t.clamp_(0.0, last)
    counts = [torch.histc(c, bins=HIST_BINS, min=0.0, max=top)
              for c in t.split(_HIST_CHUNK)]
    return (counts[0] if len(counts) == 1 else torch.stack(counts)).to(
        torch.int64).reshape(-1, HIST_BINS).sum(0)


def log_magnitude_histogram(x: torch.Tensor,
                            ax: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``(HIST_BINS,)`` float32 counts of ``|x|`` over fixed log10-magnitude
    bins (edges ``10**(HIST_LO + i*HIST_STEP)``): zeros excluded, under-
    and overflow clamped into the edge bins, non-finite elements in the
    last bin. ``ax``: ``|x|`` in float32 if the caller has it. Counted in
    int64, so a bin is exact above 2^24 (the JAX package's float32
    scatter-add stops counting at 16,777,216)."""
    return _hist_counts(x, ax).to(torch.float32)


def _sq(x: torch.Tensor) -> torch.Tensor:
    """``||x||^2`` in float32. On the card one ``vector_norm``
    reduction; on the CPU a sum of squares, since torch's CPU
    ``vector_norm`` accumulates float32 in sequence (8.5e-5 low against
    float64 at 2.5 M elements, 1.4e-3 at 40 M)."""
    x = x.detach().to(torch.float32)
    if x.is_cuda:
        return torch.square(torch.linalg.vector_norm(x))
    return torch.sum(x * x)


def _norm(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().to(torch.float32)
    if x.is_cuda:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(torch.sum(x * x))


def _carry_sq(x, zero, group, downlink: bool) -> torch.Tensor:
    """This rank's share of a piece's sum of squares: a tensor's own, or a
    per-level carry tuple's sum over its slots (one combined norm, the JAX
    package's ``l2_carry``). Downlink slot ``j`` is the same on the ranks
    along the axes after ``j``; its share is divided by their count, so
    the group's sum counts it once."""
    if x is None:
        return zero
    if not isinstance(x, tuple):
        return _sq(x)
    sizes = list(group.axis_sizes.values())
    total = zero
    for j, slot in enumerate(x):
        if slot is None:
            continue
        copies = 1
        if downlink:
            for size in sizes[j + 1:]:
                copies *= size
        total = total + _sq(slot) / copies
    return total


def device_round_metrics(transmit, update, new_ps, state, guard_ok=None,
                         hists: bool = False, group=None,
                         sharded_state: bool = False,
                         transmit_max: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One ``(len(metric_schema(hists)),)`` float32 device vector from
    tensors the server phase holds: ``transmit`` the round's transmit as
    the server consumed it, ``update`` the lr-scaled update, ``new_ps``
    the weights after the guard select, ``state`` the post-round
    ``ServerState``. Reductions only (one pass over the update for its
    magnitudes, shared by its norm, nonzero count, threshold and
    histogram); no host sync.

    ``group`` (the sharded server's ``ClientGroup``): ``transmit`` is this
    rank's unreduced sum and ``qres`` / ``dres`` this rank's carries (a
    per-axis plan's: tuples of per-level slots, ``_carry_sq``),
    ``velocity`` / ``error`` this rank's slices when ``sharded_state``
    (the dense modes); their sums of squares, the transmit's largest
    magnitude and (``sharded_state``) the error histogram are combined
    over the group with one all-gather, in rank order on every rank, so
    the ranks' vectors are equal. ``transmit_max``: ``max|transmit|`` if
    the caller computed it (the guard does)."""
    dev = update.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    if transmit_max is None:
        transmit_max = torch.linalg.vector_norm(transmit.detach().to(f32),
                                                ord=_INF)
    abs_u = update.detach().to(f32).abs()
    # the smallest nonzero magnitude; 0 if there is none (inf) or a NaN
    thr = torch.where(abs_u == 0, _INF, abs_u).amin().nan_to_num_(
        nan=0.0, posinf=0.0)
    if hists:
        u_counts = _hist_counts(update, abs_u)
        nnz = u_counts.sum()
        err_counts = _hist_counts(state.error)
    else:
        nnz = torch.count_nonzero(abs_u)
    # the norms of what each rank holds a piece of under --server_shard
    pieces = [transmit, state.qres, state.dres]
    if sharded_state:
        pieces += [state.velocity, state.error]
    if group is None:
        norms = [zero if x is None else _norm(x) for x in pieces]
    else:
        from commefficient_torch.ops.collectives import all_gather_tiled

        local = [_carry_sq(x, zero, group, i == 2)
                 for i, x in enumerate(pieces)]
        local = torch.stack(local + [transmit_max.to(f32)]).to(
            torch.float64)
        if hists and sharded_state:
            local = torch.cat([local, err_counts.to(torch.float64)])
        rows = all_gather_tiled(local, group).reshape(group.size, -1)
        tot = rows.sum(0)
        norms = list(torch.sqrt(tot[:len(pieces)]).to(f32).unbind())
        transmit_max = rows[:, len(pieces)].amax().to(f32)
        if hists and sharded_state:
            err_counts = tot[len(pieces) + 1:]
    t_n, q_n, d_n = norms[:3]
    v_n, e_n = norms[3:] if sharded_state else (_norm(state.velocity),
                                                _norm(state.error))
    out = torch.stack((
        t_n, transmit_max, _norm(abs_u), nnz.to(f32), thr, v_n, e_n, q_n,
        _norm(new_ps),
        torch.linalg.vector_norm(new_ps.detach().to(f32), ord=_INF),
        guard_ok.to(f32) if guard_ok is not None else zero + 1.0,
        d_n))
    if hists:
        out = torch.cat([out, u_counts.to(f32), err_counts.to(f32)])
    assert out.shape == (len(metric_schema(hists)),)
    return out


def collective_ledger(mode: str, grad_size: int, *, sketch=None,
                      n_shard: int = 0, reduce_dtype: str = "float32",
                      k: int = 0, plan=None, lowering=None, axis_sizes=None,
                      axis_placement=None) -> Dict[str, Dict[str, Any]]:
    """The static per-round wire-byte ledger, one entry per collective
    leg, priced by ``ops.collectives.payload_bytes`` as the JAX package's
    ``collective_ledger`` prices them (logical payload per device per
    round; ring factors excluded). ``plan`` prices each leg at its wire
    dtype (``reduce_dtype`` is the legacy alias). A leg that ``lowering``
    (``ops/collectives.plan_lowering``) makes hierarchical gains
    ``bytes_per_axis`` (``{axis: {dtype, elements, bytes_per_round,
    placement}}``), each level priced at its real input size: the
    scatter and gather levels shrink by each axis already reduced
    (``axis_sizes``), the table all-reduce moves the whole table at every
    level; ``axis_placement`` labels each axis ``ici`` / ``dcn``."""
    from commefficient_torch.ops.collectives import (
        DEFAULT_QUANT_BLOCK,
        payload_bytes,
        plan_from_reduce_dtype,
    )

    if plan is None:
        plan = plan_from_reduce_dtype(reduce_dtype)
    d = int(grad_size)
    ledger: Dict[str, Dict[str, Any]] = {}

    def leg(name, collective, elems, dtype, block=DEFAULT_QUANT_BLOCK):
        if dtype != "float32":
            collective = f"{collective} ({dtype}+scales)"
        ledger[name] = {"collective": collective, "elements": int(elems),
                        "dtype": dtype,
                        "bytes_per_round": int(payload_bytes(int(elems),
                                                             dtype, block))}

    def leg_low(name):
        # the leg's lowering tuple, or None for a flat leg
        key = {"transmit_reduce": "table" if mode == "sketch" else "uplink",
               "update_all_gather": "downlink"}[name]
        low = (lowering or {}).get(key)
        return low if isinstance(low, tuple) else None

    def per_axis_leg(name, collective, elems, low,
                     block=DEFAULT_QUANT_BLOCK, shrink=False):
        # one wire level an axis, in reduce order
        per_axis = {}
        total, seen = 0, 1
        for ax, dt in low:
            lvl = int(elems) // seen if shrink else int(elems)
            b = int(payload_bytes(lvl, dt, block))
            per_axis[ax] = {
                "dtype": dt, "elements": lvl, "bytes_per_round": b,
                "placement": (axis_placement or {}).get(ax, "ici")}
            total += b
            if shrink:
                assert axis_sizes is not None, \
                    "per-axis ledger needs axis_sizes={axis: size}"
                seen *= int(axis_sizes[ax])
        ledger[name] = {
            "collective": f"{collective} (per-axis)",
            "elements": int(elems),
            "dtype": "/".join(f"{ax}:{dt}" for ax, dt in low),
            "bytes_per_round": total,
            "bytes_per_axis": per_axis}

    if mode == "sketch":
        table_elems = sketch.r * sketch.c_pad if sketch is not None else 0
        c_pad = sketch.c_pad if sketch is not None else None
        leg("client_uplink", "transmit", table_elems, "float32")
        if leg_low("transmit_reduce") is not None:
            per_axis_leg("transmit_reduce", "hierarchical_psum",
                         table_elems, leg_low("transmit_reduce"),
                         block=c_pad)
        elif plan.table != "float32":
            leg("transmit_reduce", "quantized_psum", table_elems,
                plan.table, block=c_pad)
        else:
            leg("transmit_reduce", "psum", table_elems, "float32")
    else:
        per_client = k if mode == "local_topk" else d
        leg("client_uplink", "transmit", per_client, "float32")
        d_pad = -(-d // n_shard) * n_shard if n_shard else d
        if n_shard and leg_low("transmit_reduce") is not None:
            per_axis_leg("transmit_reduce", "hierarchical_psum_scatter",
                         d_pad, leg_low("transmit_reduce"), shrink=True)
        elif n_shard and plan.uplink != "float32":
            leg("transmit_reduce", "quantized_psum_scatter", d_pad,
                plan.uplink)
        elif n_shard:
            leg("transmit_reduce", "psum_scatter", d_pad, "float32")
        else:
            leg("transmit_reduce", "psum", d, "float32")

    if n_shard:
        if mode == "sketch" and sketch is not None:
            up_elems = (-(-sketch.T // n_shard) * n_shard
                        * sketch.sublanes * 128)
            down_block = sketch.sublanes * 128
        else:
            up_elems = -(-d // n_shard) * n_shard
            down_block = DEFAULT_QUANT_BLOCK
        if leg_low("update_all_gather") is not None:
            per_axis_leg("update_all_gather", "hierarchical_all_gather",
                         up_elems, leg_low("update_all_gather"),
                         block=down_block, shrink=True)
        elif plan.downlink != "float32":
            leg("update_all_gather", "quantized_all_gather", up_elems,
                plan.downlink, block=down_block)
        else:
            leg("update_all_gather", "all_gather", up_elems, "float32")
        if mode in ("sketch", "true_topk"):
            # the top-k count exchange: 16 int32 candidates a pass, about
            # 8 passes; listed so the ledger is complete
            ledger["threshold_exchange"] = {
                "collective": "psum (count exchange)",
                "elements": 16 * 8, "dtype": "int32",
                "bytes_per_round": 4 * 16 * 8}
    return ledger


def _json_safe(x):
    """Non-finite floats as the strings ``'nan'`` / ``'inf'`` /
    ``'-inf'`` (``float()`` reads them back), recursively, so every line
    is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return x


# --------------------------------------------------------------------------
# the watch plane
# --------------------------------------------------------------------------

class WatchRule(NamedTuple):
    """One watch rule over the drained metric stream; the spec grammar is
    the JAX package's: ``METRIC OP BOUND [@N] [->ACTION]`` with OP ``>``
    or ``<``, BOUND a float or ``ewma*F`` (F times the rule's EWMA of the
    metric, armed after ``WATCH_WARMUP`` observations), ``@N`` N
    consecutive violating rounds, ACTION ``log`` (default), ``trace[:R]``
    (request a trace of the next R rounds) or ``checkpoint`` (request a
    run-state save). A non-finite value violates any rule on its
    metric."""

    metric: str
    op: str                      # '>' | '<'
    bound: float                 # absolute threshold (ewma_factor == 0)
    ewma_factor: float           # > 0: bound = factor * EWMA(history)
    consecutive: int
    action: str                  # 'log' | 'trace' | 'checkpoint'
    trace_rounds: int
    spec: str                    # the source text, logged verbatim


WATCH_WARMUP = 5          # observations before an EWMA bound arms
WATCH_EWMA_ALPHA = 0.25   # EWMA update weight of the newest observation
WATCH_COOLDOWN = 8        # rounds a fired rule stays silent
WATCH_TRACE_ROUNDS = 3    # default trace-reaction window length

# the JAX package's default rule set, verbatim (rules on metrics of planes
# the port does not carry yet never observe a value and never fire)
DEFAULT_WATCH_RULES = (
    "loss>ewma*4@2->trace",
    "transmit_norm>ewma*10->trace",
    "error_norm>ewma*8@3",
    "qres_norm>ewma*8@3",
    "dres_norm>ewma*8@3",
    "update_nnz<ewma*0.25@2",
    "occupancy<ewma*0.5@4",
    "prefetch_miss>0.5@8",
    "rounds_per_sec<ewma*0.5@4",
    "io_retry>ewma*8@3",
    "io_error>0.5->checkpoint",
    "worker_queue_age>ewma*8@4->trace",
    "io_corrupt>0.5",
    "scrub_mismatch>0.5->checkpoint",
)

# every name a rule may observe, so a typo fails at startup
WATCH_METRIC_NAMES = frozenset(METRIC_FIELDS) | {
    "loss", "occupancy", "dispatch_ms", "compute_ms", "drain_fetch_ms",
    "dispatch_to_drain_ms", "rounds_per_sec", "prefetch_miss",
    "io_retry", "io_error", "worker_queue_age",
    "io_corrupt", "scrub_mismatch",
}

# rule name -> the offload-span key carrying its per-round value
_IO_WATCH_KEYS = {"io_retry": "io_retries", "io_error": "io_errors",
                  "worker_queue_age": "queue_age_ms",
                  "io_corrupt": "io_corrupt",
                  "scrub_mismatch": "scrub_mismatch"}


def parse_watch_rules(spec: str) -> List[WatchRule]:
    """Parse a ','-joined rule spec (``WatchRule``); empty entries are
    skipped, a malformed one (an unknown metric included) raises."""
    rules = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        body, action, trace_rounds = part, "log", WATCH_TRACE_ROUNDS
        if "->" in body:
            body, act = body.split("->", 1)
            act = act.strip()
            if act.startswith("trace"):
                action = "trace"
                if ":" in act:
                    trace_rounds = int(act.split(":", 1)[1])
                    assert trace_rounds >= 1, part
            elif act in ("log", "checkpoint"):
                action = act
            else:
                raise ValueError(
                    f"watch rule {part!r}: unknown action {act!r}; use "
                    "log | trace[:N] | checkpoint")
        consecutive = 1
        if "@" in body:
            body, n = body.rsplit("@", 1)
            consecutive = int(n)
            assert consecutive >= 1, part
        op = ">" if ">" in body else ("<" if "<" in body else None)
        if op is None:
            raise ValueError(
                f"watch rule {part!r}: expected METRIC>BOUND or "
                "METRIC<BOUND (BOUND a float or ewma*F)")
        metric, bound_s = (s.strip() for s in body.split(op, 1))
        assert metric, f"watch rule {part!r}: empty metric name"
        if metric not in WATCH_METRIC_NAMES:
            raise ValueError(
                f"watch rule {part!r}: unknown metric {metric!r}; known "
                f"names: {', '.join(sorted(WATCH_METRIC_NAMES))}")
        bound, factor = 0.0, 0.0
        if bound_s.startswith("ewma"):
            factor = (float(bound_s.split("*", 1)[1])
                      if "*" in bound_s else 1.0)
            assert factor > 0, f"watch rule {part!r}: ewma factor <= 0"
        else:
            bound = float(bound_s)
        rules.append(WatchRule(metric=metric, op=op, bound=bound,
                               ewma_factor=factor, consecutive=consecutive,
                               action=action, trace_rounds=trace_rounds,
                               spec=part))
    return rules


class _RuleState:
    __slots__ = ("ewma", "n", "consec", "cooldown_until", "fired")

    def __init__(self):
        self.ewma = 0.0
        self.n = 0
        self.consec = 0
        self.cooldown_until = -1
        self.fired = 0


class WatchEngine:
    """Evaluates watch rules over each drained round record
    (``RunTelemetry.on_drained`` calls ``observe``): host arithmetic on
    fetched values. An alert is a ``watch_alert`` event; the trace
    reaction asks the attached ``profiling.RoundTracer`` for a window, the
    checkpoint reaction sets ``checkpoint_pending`` for the training
    loop."""

    def __init__(self, rules: Sequence[WatchRule], telemetry=None,
                 tracer=None):
        self.rules = list(rules)
        self._rt = telemetry
        self.tracer = tracer
        self._state = [_RuleState() for _ in self.rules]
        self._last_dispatch_t: Optional[float] = None
        self.alerts = 0
        self.fired: List[Tuple[int, str]] = []   # (round, rule spec)
        self.checkpoint_pending = False

    def pop_checkpoint(self) -> bool:
        """True once per pending checkpoint request."""
        pending, self.checkpoint_pending = self.checkpoint_pending, False
        return pending

    def _value(self, rec: Dict[str, Any], name: str):
        metrics = rec.get("metrics") or {}
        if name in metrics:
            return metrics[name]
        if name in ("loss", "occupancy", "dispatch_ms", "compute_ms",
                    "drain_fetch_ms", "dispatch_to_drain_ms"):
            return rec.get(name)
        if name == "prefetch_miss":
            off = rec.get("offload")
            if not off or "prefetch" not in off:
                return None
            return 1.0 if off["prefetch"] == "miss" else 0.0
        if name in _IO_WATCH_KEYS:
            off = rec.get("offload")
            if not off:
                return None
            return off.get(_IO_WATCH_KEYS[name])
        if name == "rounds_per_sec":
            return rec.get("_rounds_per_sec")
        return None

    def observe(self, rec: Dict[str, Any]) -> None:
        """Evaluate every rule against one drained round record."""
        round_no = rec.get("round", -1)
        # rounds/sec from successive dispatch stamps
        t_disp = rec.get("t_dispatch")
        if t_disp is not None:
            if self._last_dispatch_t is not None \
                    and t_disp > self._last_dispatch_t:
                rec["_rounds_per_sec"] = 1.0 / (t_disp
                                                - self._last_dispatch_t)
            self._last_dispatch_t = t_disp
        for rule, st in zip(self.rules, self._state):
            raw = self._value(rec, rule.metric)
            if raw is None or isinstance(raw, bool):
                continue
            try:
                v = float(raw)
            except (TypeError, ValueError):
                continue
            finite = math.isfinite(v)
            if rule.ewma_factor > 0:
                armed = st.n >= WATCH_WARMUP
                bound = rule.ewma_factor * st.ewma
                if finite:
                    st.ewma = (v if st.n == 0 else
                               (1 - WATCH_EWMA_ALPHA) * st.ewma
                               + WATCH_EWMA_ALPHA * v)
                    st.n += 1
                if not armed:
                    continue
            else:
                bound = rule.bound
            violated = (not finite) or (v > bound if rule.op == ">"
                                        else v < bound)
            if round_no <= st.cooldown_until:
                continue
            if not violated:
                st.consec = 0
                continue
            st.consec += 1
            if st.consec < rule.consecutive:
                continue
            self._fire(rule, st, round_no, v, bound)
        rec.pop("_rounds_per_sec", None)

    def _fire(self, rule: WatchRule, st: _RuleState, round_no: int,
              value: float, bound: float) -> None:
        st.consec = 0
        st.cooldown_until = round_no + WATCH_COOLDOWN
        st.fired += 1
        self.alerts += 1
        self.fired.append((round_no, rule.spec))
        traced = False
        if rule.action == "trace" and self.tracer is not None:
            traced = self.tracer.request(rule.trace_rounds)
        if rule.action == "checkpoint":
            self.checkpoint_pending = True
        if self._rt is not None:
            self._rt.event(
                "watch_alert", round=round_no, rule=rule.spec,
                metric=rule.metric, value=value, bound=bound,
                fire=st.fired, action=rule.action,
                **({"trace_requested": traced}
                   if rule.action == "trace" else {}))
        print(f"WATCH alert at round {round_no}: {rule.spec} "
              f"(value {value:g}, bound {bound:g}, action {rule.action})")


# --------------------------------------------------------------------------
# the run event log
# --------------------------------------------------------------------------

class RunTelemetry:
    """The host-side recorder: buffers each round's spans in memory and
    writes one JSONL line per drained round, plus immediate lines for
    lifecycle events. It never touches a device tensor: the round's
    metric vector arrives fetched (``FedModel.finish_rounds``). Every line
    is flushed as written, so a killed run leaves a readable log."""

    def __init__(self, path: str, run_info: Optional[dict] = None,
                 schema: Optional[Sequence[str]] = None):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")
        self._spans: Dict[int, Dict[str, Any]] = {}
        self.rounds = 0
        self.events = 0
        self._closed = False
        self.watch: Optional[WatchEngine] = None
        self.event("run_start",
                   schema=list(schema if schema is not None
                               else METRIC_FIELDS),
                   **(run_info or {}))

    def event(self, ev: str, **fields) -> None:
        if self._closed:
            return
        rec = {"ev": ev, "t": time.time()}
        rec.update(fields)
        self._f.write(json.dumps(_json_safe(rec), allow_nan=False) + "\n")
        self._f.flush()
        self.events += 1

    def on_dispatch(self, round_no: int, t_start: float,
                    occupancy: int) -> None:
        """After the seal: ``t_start`` is the monotonic stamp taken before
        the round's dispatch, ``occupancy`` the in-flight window depth
        including this round. Host values only."""
        now = time.monotonic()
        self._spans[round_no] = {
            "t_wall": time.time(),
            "t0": t_start,
            "dispatch_ms": (now - t_start) * 1e3,
            "t_sealed": now,
            "occupancy": occupancy,
        }

    def on_complete(self, round_no: int) -> None:
        """The engine's window wait for this round just returned."""
        span = self._spans.get(round_no)
        if span is not None and "compute_ms" not in span:
            span["compute_ms"] = (time.monotonic() - span["t_sealed"]) * 1e3

    def on_metrics(self, round_no: int, metrics: Optional[Dict[str, float]],
                   loss: Optional[float] = None,
                   guard_ok: Optional[bool] = None,
                   cohort: Optional[Dict[str, Any]] = None,
                   offload: Optional[Dict[str, Any]] = None) -> None:
        """The round's fetched values (``FedModel.finish_rounds``);
        ``metrics`` is None for an async buffered dispatch, which has no
        server phase."""
        span = self._spans.setdefault(round_no, {})
        if metrics is not None:
            span["metrics"] = metrics
        if loss is not None:
            span["loss"] = loss
        if guard_ok is not None:
            span["guard_ok"] = guard_ok
        if cohort:
            span["cohort"] = cohort
        if offload:
            span["offload"] = offload

    def on_drained(self, round_no: int, fetch_s: float) -> None:
        """Write the round's ``round`` line, then let the watch plane
        read it."""
        span = self._spans.pop(round_no, {})
        now = time.monotonic()
        rec: Dict[str, Any] = {"ev": "round", "round": round_no,
                               "t": time.time()}
        if "t_wall" in span:
            rec["t_dispatch"] = span["t_wall"]
            rec["dispatch_ms"] = round(span["dispatch_ms"], 3)
            rec["dispatch_to_drain_ms"] = round((now - span["t0"]) * 1e3, 3)
            rec["occupancy"] = span["occupancy"]
        if "compute_ms" in span:
            rec["compute_ms"] = round(span["compute_ms"], 3)
        rec["drain_fetch_ms"] = round(fetch_s * 1e3, 3)
        for key in ("loss", "guard_ok", "cohort", "offload", "metrics"):
            if key in span:
                rec[key] = span[key]
        self._f.write(json.dumps(_json_safe(rec), allow_nan=False) + "\n")
        self._f.flush()
        self.rounds += 1
        self.events += 1
        if self.watch is not None:
            # after the round line, so its alerts follow it in the log
            self.watch.observe(rec)

    def close(self, **totals) -> None:
        if self._closed:
            return
        # dispatched but never drained (e.g. the window at a fatal guard)
        for round_no in sorted(self._spans):
            span = self._spans[round_no]
            rec = {"round": round_no}
            for key in ("dispatch_ms", "occupancy", "compute_ms", "loss",
                        "guard_ok", "cohort", "offload", "metrics"):
                if key in span:
                    rec[key] = span[key]
            self.event("round_partial", **rec)
        self._spans.clear()
        self.event("run_end", rounds=self.rounds, **totals)
        self._closed = True
        self._f.close()


def attach_run_telemetry(args, fed_model, log_dir: str,
                         entrypoint: str) -> Optional[RunTelemetry]:
    """Entry-point hook (``cv_train`` / ``gpt2_train``): the round tracer
    (``--trace_rounds`` windows, and the watch plane's trace reaction) as
    ``fed_model.tracer``, and with ``--telemetry`` the run's recorder as
    ``fed_model.telemetry``, its ``run_start`` event carrying the ledger,
    the schema and the run's config in the JAX package's fields, and the
    watch engine (``--watch``). Under a client group only rank 0 attaches
    (the other ranks compute the same verdicts and write nothing).
    Returns the recorder, or None."""
    from commefficient_torch.profiling import RoundTracer, parse_trace_rounds

    if not fed_model.is_main:
        return None
    trace_spec = (getattr(args, "trace_rounds", "") or "").strip()
    watch_on = bool(getattr(args, "watch", False))
    tracer = None
    if trace_spec or (watch_on and getattr(args, "telemetry", False)):
        tracer = RoundTracer(log_dir, windows=parse_trace_rounds(trace_spec))
        fed_model.tracer = tracer
        if trace_spec:
            print(f"trace_rounds: windowed round-aligned capture(s) "
                  f"{trace_spec} -> {log_dir}/trace_round_*")
    if not getattr(args, "telemetry", False):
        return None
    hists = bool(getattr(args, "telemetry_hist", False))
    path = os.path.join(log_dir, "telemetry.jsonl")
    plan = fed_model.round_config.collective_plan
    group = fed_model.group
    ledger = collective_ledger(
        args.mode, fed_model.grad_size, sketch=fed_model.sketch,
        n_shard=fed_model._n_shard,
        reduce_dtype=getattr(args, "reduce_dtype", "float32") or "float32",
        k=args.k, plan=plan, lowering=fed_model._plan_lowering,
        axis_sizes=fed_model._axis_sizes,
        axis_placement=(group.axis_placement() if group is not None
                        else None))
    run_info = {
        "entrypoint": entrypoint,
        "mode": args.mode,
        "grad_size": fed_model.grad_size,
        "num_workers": args.num_workers,
        "num_clients": fed_model.num_clients,
        "server_shard": bool(getattr(args, "server_shard", False)),
        "reduce_dtype": getattr(args, "reduce_dtype", "float32"),
        "guards": bool(getattr(args, "guards", False)),
        "seed": args.seed,
        "backend": fed_model.device.type,
        "ledger": ledger,
    }
    if group is not None:
        # the grid: axes, sizes, placements and the process count, so the
        # log alone says whether a leg's bytes crossed nodes
        run_info["mesh"] = group.topology()
    # the participation layer's config and the churn schedule (both are
    # seeded, so spec and seed are the whole trajectory)
    run_info["participation"] = (getattr(args, "participation", "")
                                 or "1.0")
    run_info["participation_sampling"] = getattr(
        args, "participation_sampling", "uniform")
    run_info["staleness_decay"] = float(getattr(args, "staleness_decay",
                                                0.5))
    fault_spec = (getattr(args, "inject_client_fault", "") or "").strip()
    if fault_spec:
        from commefficient_torch.federated.participation import (
            parse_client_fault,
        )

        sched = parse_client_fault(fault_spec)
        run_info["client_fault"] = {
            "spec": sched.spec(), "drop": sched.drop, "slow": sched.slow,
            "corrupt": sched.corrupt, "delay": sched.delay,
            "seed": sched.seed,
            "quarantine_after": sched.quarantine_after}
    else:
        run_info["client_fault"] = None
    churn_spec = (getattr(args, "churn", "") or "").strip()
    if churn_spec:
        from commefficient_torch.federated.participation import parse_churn

        csched = parse_churn(churn_spec)
        run_info["churn"] = {
            "spec": csched.spec(), "join": csched.join,
            "depart": csched.depart, "init": csched.init,
            "seed": csched.seed, "compact": csched.compact}
    else:
        run_info["churn"] = None
    async_k = int(getattr(args, "async_buffer", 0) or 0)
    run_info["async"] = ({"buffer": async_k,
                          "staleness_decay": float(
                              getattr(args, "staleness_decay", 0.5))}
                         if async_k else None)
    # the client-state tier and what a round streams, and the disk tier's
    # resolved I/O plane (obs_report's "Host offload" section)
    mem_plan = getattr(fed_model, "memory_plan", None)
    if mem_plan is not None and getattr(fed_model, "streaming", False):
        run_info["state_placement"] = mem_plan.placement
        run_info["state_row_bytes"] = int(mem_plan.row_bytes)
        run_info["state_slot_bytes"] = int(
            getattr(fed_model, "_slot_bytes", mem_plan.row_bytes))
        run_info["state_rows_per_round"] = int(args.num_workers)
    elif mem_plan is not None and mem_plan.total_bytes:
        run_info["state_placement"] = mem_plan.placement
    store = getattr(fed_model, "_row_store", None)
    if store is not None:
        run_info["state_io"] = {
            "queue_bound": int(store.queue_bound),
            "retries": int(store.io_retries),
            "backoff_ms": float(store.io_backoff_ms),
            "deadline_ms": float(store.io_deadline_ms),
            "quarantine_after": int(store.quarantine_after),
            "checksums": bool(store.checksums),
            "scrub_rows": int(store.scrub_rows),
            "inject": (store.inject.schedule.spec()
                       if store.inject is not None else None),
        }
    if plan is not None:
        run_info["collective_plan"] = plan.spec()
    if getattr(fed_model, "plan_report", None):
        # the --collective_plan auto probe's report
        run_info["collective_plan_probe"] = fed_model.plan_report
    run_info["telemetry_hist"] = hists
    rule_spec = (getattr(args, "watch_rules", "") or "").strip()
    rules = (parse_watch_rules(rule_spec) if rule_spec
             else parse_watch_rules(",".join(DEFAULT_WATCH_RULES)))
    run_info["watch"] = ([r.spec for r in rules] if watch_on else None)
    if trace_spec:
        run_info["trace_rounds"] = trace_spec
    rt = RunTelemetry(path, run_info=run_info, schema=metric_schema(hists))
    if watch_on:
        rt.watch = WatchEngine(rules, telemetry=rt, tracer=tracer)
    fed_model.telemetry = rt
    print(f"telemetry: run event log -> {path} (--no_telemetry disables"
          + (f"; watch plane ON, {len(rules)} rules — --no_watch disables"
             if watch_on else "") + ")")
    return rt


def close_run_telemetry(fed_model, rt: Optional[RunTelemetry]) -> None:
    """Run end (the entry points' ``finally``): stop a trace window left
    open, its record still going to the log; on the disk tier log the
    storage-fault terminal error (``io_fatal``) and the run's I/O and
    integrity totals (``io_counters``); close the log with ``run_end``."""
    tracer = getattr(fed_model, "tracer", None)
    if tracer is not None:
        cap = tracer.close()
        if cap is not None and rt is not None:
            rt.event("trace_captured", **cap)
    store = getattr(fed_model, "_row_store", None)
    if store is not None and rt is not None:
        if store.fatal_error is not None:
            rt.event("io_fatal", error=str(store.fatal_error))
        rt.event("io_counters", **store.io_counters())
    if rt is not None:
        rt.close()


def watch_can_checkpoint(args) -> bool:
    """Whether the run's watch rules can request a checkpoint (the same
    answer on every rank: it reads only the flags)."""
    if not (getattr(args, "telemetry", False)
            and getattr(args, "watch", False)):
        return False
    spec = ((getattr(args, "watch_rules", "") or "").strip()
            or ",".join(DEFAULT_WATCH_RULES))
    return any(r.action == "checkpoint" for r in parse_watch_rules(spec))


def take_watch_checkpoint(fed_model, armed: bool, drained: bool) -> bool:
    """The watch plane's checkpoint reaction at a round boundary: True
    when the run should save now. On one process, the engine's pending
    request. Under a client group the engine runs on rank 0 alone
    (``attach_run_telemetry``) while the save is collective, so every
    rank takes rank 0's request from a one-element MAX all-reduce. That
    happens only at a boundary where the round engine just drained
    (``drained``, the same on every rank: a request arises only from
    drained rounds) and only when a rule can request a save (``armed``,
    ``watch_can_checkpoint``), so the rounds between drains stay free of
    host syncs."""
    watch = getattr(getattr(fed_model, "telemetry", None), "watch", None)
    group = fed_model.group
    if group is None or group.size == 1:
        return watch is not None and watch.pop_checkpoint()
    if not (armed and drained):
        return False
    flag = torch.tensor([int(watch is not None and watch.pop_checkpoint())],
                        dtype=torch.int32, device=group.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group.group)
    return bool(flag.item())


def read_events(path: str) -> Iterator[dict]:
    """Yield the JSONL events of a run log, stopping at a torn trailing
    line."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                return
