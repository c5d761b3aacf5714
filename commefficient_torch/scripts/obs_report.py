"""Render a run summary from a telemetry JSONL event log: the port's copy
of the JAX package's ``scripts/obs_report.py``, which reads the log
through ``commefficient_torch.telemetry.read_events`` and imports nothing
of JAX. Given the same log it prints the same bytes in every mode.

The read side of the zero-sync telemetry plane (docs/observability.md):
given the ``telemetry.jsonl`` a training run wrote (cv_train/gpt2_train
with ``--telemetry``, the default), print

- the run header (config, backend, rounds, wall span, rounds/sec);
- the round-lifecycle timeline (dispatch / device-compute / drain-fetch /
  dispatch-to-drain latencies with p50/p90, in-flight-window occupancy);
- the compression ledger: the static per-collective wire bytes from the
  run_start event priced over the drained rounds, next to the runtime
  compression signals (resolved k, top-k threshold, error-carry residual);
- the guard / rollback history: every guard_trip, rollback, and
  guard_fatal event, plus the rounds whose drained metrics carried a
  tripped verdict;
- the participation, async, host-offload, supervisor, churn and serving
  sections where the log carries their events;
- checkpoints, resumes, and epoch rows, in timeline order.

The LAST line of output is always one machine-readable JSON object
(``summary_dict``) so CI can consume the numbers without parsing prose.
The tail carries ``alerts`` (count + worst watch rule) and the schema-v3
histogram summaries.

Usage:
    python -m commefficient_torch.scripts.obs_report RUN_DIR_OR_JSONL [--json]
    python -m commefficient_torch.scripts.obs_report RUN_DIR_OR_JSONL \
        --follow [--interval S]
    python -m commefficient_torch.scripts.obs_report --compare RUN_A RUN_B
    python -m commefficient_torch.scripts.obs_report --fleet FLEET_DIR

``--json`` suppresses the human report and prints only the JSON tail.
``--follow`` live-tails a run IN PROGRESS: a refreshing round table +
active watch alerts, re-rendered as flushed lines land (the torn-tail
buffering reader makes this safe on a live file — a partially written
line is held until its newline arrives). ``--compare A B`` prints a
span/metric delta table between two run logs (A/B legs). ``--fleet``
renders an orchestrator's ``fleet_events.jsonl``. A SIGKILL'd run's log
is readable too (lines are flushed as written and a torn trailing line
is skipped by the reader).

Events with an unknown ``ev`` kind (logs from a newer schema) are
SKIPPED, never a crash — a report tool must read forward-compatible.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, List

from commefficient_torch.telemetry import read_events


def _pct(xs: List[float], p: float):
    if not xs:
        return None
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(p * len(ys)))]


def _mean(xs: List[float]):
    return (sum(xs) / len(xs)) if xs else None


def _fin(x):
    """JSON-safe float: non-finite values (a poisoned round's NaN norms
    are real data) become their string names so the tail line stays strict
    JSON for jq-style consumers."""
    if x is None or isinstance(x, str):
        return x
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def load_events(path: str) -> List[dict]:
    """Accept either the jsonl file or a run dir containing one.
    Records without an ``ev`` kind are dropped here — every consumer
    below keys on it, and a malformed line must never crash a report."""
    if os.path.isdir(path):
        path = os.path.join(path, "telemetry.jsonl")
    return [e for e in read_events(path)
            if isinstance(e, dict) and "ev" in e]


def _hist_summary(rounds: List[dict], prefix: str):
    """Schema-v3 histogram digest over the drained rounds: per-bin mean
    counts + the modal bin. Name-keyed off the metrics dicts, so v1/v2
    logs (no hist fields) simply return None."""
    names = sorted({k for e in rounds for k in (e.get("metrics") or {})
                    if k.startswith(prefix)},
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    if not names:
        return None
    means = []
    for name in names:
        vals = [e["metrics"][name] for e in rounds
                if name in (e.get("metrics") or {})
                and isinstance(e["metrics"][name], (int, float))
                and math.isfinite(e["metrics"][name])]
        means.append(round(sum(vals) / len(vals), 2) if vals else 0.0)
    modal = max(range(len(means)), key=lambda i: means[i]) if means \
        else None
    return {"mean_counts": means, "modal_bin": modal,
            "bins": len(names)}


def summarize(events: List[dict]) -> Dict[str, Any]:
    """The machine-readable digest: everything the human report prints,
    as one dict (tests compare this against the live run's counters)."""
    run_info = next((e for e in events if e.get("ev") == "run_start"), {})
    rounds = [e for e in events if e.get("ev") == "round"]
    trips = [e for e in events if e.get("ev") == "guard_trip"]
    rollbacks = [e for e in events if e.get("ev") == "rollback"]
    fatals = [e for e in events if e.get("ev") == "guard_fatal"]
    drains = [e for e in events if e.get("ev") == "drain"]
    run_end = next((e for e in events if e.get("ev") == "run_end"), None)

    tripped_rounds = sorted(
        {e["round"] for e in trips}
        | {e["round"] for e in rounds if e.get("guard_ok") is False})

    def span_list(key):
        return [e[key] for e in rounds if key in e]

    wall = None
    rps = None
    stamps = [e.get("t_dispatch", e["t"]) for e in rounds]
    if len(stamps) >= 2:
        wall = max(e["t"] for e in rounds) - min(stamps)
        rps = (len(rounds) / wall) if wall > 0 else None

    ledger = run_info.get("ledger", {})
    ledger_totals = {
        leg: {"bytes_per_round": row["bytes_per_round"],
              "collective": row["collective"],
              "dtype": row.get("dtype"),
              "total_bytes": row["bytes_per_round"] * len(rounds),
              # per-mesh-axis split of hierarchical legs
              # (docs/multihost.md) — carried through for the ici/dcn
              # wire-split line in the ledger section
              "bytes_per_axis": row.get("bytes_per_axis")}
        for leg, row in ledger.items()}

    def metric_mean(name):
        # non-finite metric values arrive as the strings 'nan'/'inf'
        # (telemetry._json_safe keeps the log strict JSON); they are
        # excluded from means the same way bare non-finite floats were
        vals = [e["metrics"][name] for e in rounds
                if "metrics" in e and name in e["metrics"]
                and isinstance(e["metrics"][name], (int, float))
                and math.isfinite(e["metrics"][name])]
        return (sum(vals) / len(vals)) if vals else None

    # Participation section (federated/participation.py,
    # docs/fault_tolerance.md): rebuilt entirely from the per-round
    # `cohort` span fields + the run header — the acceptance drill is
    # that a fault-injected run's participation history reproduces from
    # the JSONL log ALONE (tests/test_participation.py compares these
    # totals against the live controller's counters).
    cohorts = [e["cohort"] for e in rounds if "cohort" in e]
    landed = [rec for c in cohorts for rec in c.get("landed", [])]
    staleness_hist: Dict[str, int] = {}
    for rec in landed:
        key = str(rec.get("delay"))
        staleness_hist[key] = staleness_hist.get(key, 0) + 1
    retry_ladder: Dict[str, int] = {}
    for c in cohorts:
        for attempt in c.get("retry_attempts", []):
            retry_ladder[str(attempt)] = retry_ladder.get(str(attempt),
                                                          0) + 1
    expired = sum(e.get("count", 0) for e in events
                  if e.get("ev") == "straggler_expired")
    participation = {
        "participation": run_info.get("participation"),
        "sampling": run_info.get("participation_sampling"),
        "staleness_decay": run_info.get("staleness_decay"),
        "client_fault": run_info.get("client_fault"),
        "cohort_target": next((c["target"] for c in cohorts
                               if "target" in c), None),
        "dropped": sum(c.get("dropped", 0) for c in cohorts),
        "slow": sum(c.get("slow", 0) for c in cohorts),
        "corrupt": sum(c.get("corrupt", 0) for c in cohorts),
        "requeued": sum(c.get("requeued", 0) for c in cohorts),
        "abandoned": sum(c.get("abandoned", 0) for c in cohorts),
        "landed": len(landed),
        "landed_weight_mean": _mean([rec["weight"] for rec in landed
                                     if isinstance(rec.get("weight"),
                                                   (int, float))]),
        "expired": expired,
        "fault_skips": len([c for c in cohorts if c.get("fault_skip")]),
        "quarantined": max((c.get("quarantined_total", 0)
                            for c in cohorts), default=0),
        "staleness_hist": staleness_hist,
        "retry_ladder": retry_ladder,
    }

    # Async section (--async_buffer, federated/participation.py,
    # docs/async.md): rebuilt entirely from the per-round cohort `async`
    # sub-records + the `async_expired` run event + the run header —
    # the same log-alone reproducibility drill as the participation
    # section (tests/test_async.py compares these totals against the
    # live controller's counters).
    async_recs = [c["async"] for c in cohorts if "async" in c]
    async_info = None
    if async_recs or run_info.get("async"):
        folds = [r for r in async_recs if r.get("folded")]
        fold_stal = [s for r in folds for s in r.get("staleness", [])]
        a_stal_hist: Dict[str, int] = {}
        for rec in fold_stal:
            key = str(rec.get("delay"))
            a_stal_hist[key] = a_stal_hist.get(key, 0) + 1
        depths = [r["depth"] for r in async_recs if "depth" in r]
        async_info = {
            "buffer": (run_info.get("async") or {}).get("buffer"),
            "staleness_decay": (run_info.get("async") or {}).get(
                "staleness_decay", run_info.get("staleness_decay")),
            "dispatches": len(async_recs),
            "folds": len(folds),
            "folded_contributions": sum(r.get("folded", 0)
                                        for r in folds),
            "server_version": max((r.get("version", 0)
                                   for r in async_recs), default=0),
            "depth_mean": _mean(depths),
            "depth_max": max(depths, default=0),
            "staleness_hist": a_stal_hist,
            "stale_folds": len([s for s in fold_stal
                                if s.get("delay", 0) > 0]),
            "fold_weight_mean": _mean(
                [s["weight"] for s in fold_stal
                 if isinstance(s.get("weight"), (int, float))]),
            "masked": sum(r.get("masked", 0) for r in async_recs),
            "expired": sum(e.get("count", 0) for e in events
                           if e.get("ev") == "async_expired"),
        }

    # Host-offload section (docs/host_offload.md): rebuilt entirely from
    # the per-round `offload` span fields + the run header — the same
    # log-alone reproducibility drill as the participation section
    # (tests/test_host_offload.py compares these against the live
    # prefetcher's counters).
    offloads = [e["offload"] for e in rounds if "offload" in e]
    # storage-fault ladder events (docs/fault_tolerance.md §storage
    # faults): worker-side row quarantines surfaced as immediate events,
    # plus the terminal rung's one actionable error — the acceptance
    # drill is that the WHOLE ladder (retries → quarantines →
    # watch-forced checkpoint → fatal) reproduces from the log alone
    quarantine_events = [e for e in events
                         if e.get("ev") == "row_quarantined"]
    io_fatal = next((e.get("error") for e in reversed(events)
                     if e.get("ev") == "io_fatal"), None)
    # integrity plane (docs/fault_tolerance.md §silent corruption):
    # detection + repair events, the scrub's span totals, and the final
    # io_counters event (run totals incl. REALIZED injected-fault
    # counts — the detected-vs-injected audit's other half)
    corrupt_events = [e for e in events if e.get("ev") == "row_corrupt"]
    repair_events = [e for e in events if e.get("ev") == "row_repaired"]
    io_totals = next((e for e in reversed(events)
                      if e.get("ev") == "io_counters"), None)
    host_offload = None
    if offloads or run_info.get("state_placement") in ("host", "disk"):
        host_offload = {
            "tier": (offloads[0].get("tier") if offloads
                     else run_info.get("state_placement")),
            "rows_per_round": run_info.get("state_rows_per_round"),
            "row_bytes": run_info.get("state_row_bytes"),
            "slot_bytes": run_info.get("state_slot_bytes",
                                       run_info.get("state_row_bytes")),
            "rounds": len(offloads),
            "prefetch_hits": len([o for o in offloads
                                  if o.get("prefetch") == "hit"]),
            "prefetch_misses": len([o for o in offloads
                                    if o.get("prefetch") == "miss"]),
            "prefetch_off": len([o for o in offloads
                                 if o.get("prefetch") == "off"]),
            "gather_ms_p50": _fin(_pct([o["gather_ms"] for o in offloads
                                        if "gather_ms" in o], 0.5)),
            "gather_io_ms_p50": _fin(_pct(
                [o["gather_io_ms"] for o in offloads
                 if "gather_io_ms" in o], 0.5)),
            "scatter_ms_p50": _fin(_pct([o["scatter_ms"] for o in offloads
                                         if "scatter_ms" in o], 0.5)),
            "scatter_io_ms_p50": _fin(_pct(
                [o["scatter_io_ms"] for o in offloads
                 if "scatter_io_ms" in o], 0.5)),
            # storage-fault ladder (per-round offload-span deltas summed
            # back to run totals — matched against the live store's
            # io_counters in tests/test_io_faults.py)
            "io_retries": sum(o.get("io_retries", 0) for o in offloads),
            "io_errors": sum(o.get("io_errors", 0) for o in offloads),
            "rows_quarantined": len(quarantine_events),
            "quarantine_rounds": [e.get("round")
                                  for e in quarantine_events],
            # integrity plane (§silent corruption): every detection and
            # its resolution, plus scrub coverage — matched against the
            # live store's counters in tests/test_integrity.py
            "rows_corrupt": len(corrupt_events),
            "corrupt_rounds": [e.get("round") for e in corrupt_events],
            "rows_repaired": len(repair_events),
            "repair_sources": {
                src: len([e for e in repair_events
                          if e.get("source") == src])
                for src in sorted({e.get("source")
                                   for e in repair_events})},
            "scrub_rows": sum(o.get("scrub_rows", 0) for o in offloads),
            "scrub_mismatch": sum(o.get("scrub_mismatch", 0)
                                  for o in offloads),
            "injected": (io_totals or {}).get("injected"),
            "queue_depth_max": max(
                (o["queue_depth"] for o in offloads
                 if "queue_depth" in o), default=None),
            "queue_age_ms_p50": _fin(_pct(
                [o["queue_age_ms"] for o in offloads
                 if "queue_age_ms" in o], 0.5)),
            "io_fatal": io_fatal,
            "io_config": run_info.get("state_io"),
        }

    # Watch/alert plane (telemetry.WatchEngine, docs/observability.md):
    # the alert history rebuilt from the immediate watch_alert events —
    # count + worst rule (most fires) in the machine tail so CI can gate
    # without parsing the report body.
    alert_events = [e for e in events if e.get("ev") == "watch_alert"]
    by_rule: Dict[str, int] = {}
    for e in alert_events:
        rule = str(e.get("rule"))
        by_rule[rule] = by_rule.get(rule, 0) + 1
    worst = max(by_rule, key=by_rule.get) if by_rule else None
    alerts = {
        "count": len(alert_events),
        "worst_rule": worst,
        "worst_rule_count": by_rule.get(worst, 0) if worst else 0,
        "by_rule": by_rule,
        "rounds": [e.get("round") for e in alert_events],
        "rules": run_info.get("watch"),
    }
    trace_captures = [
        {"round_start": e.get("round_start"),
         "round_until": e.get("round_until"), "dir": e.get("dir")}
        for e in events if e.get("ev") == "trace_captured"]

    # Self-healing supervisor (scripts/supervise.py,
    # docs/fault_tolerance.md §self-healing supervisor): its own JSONL
    # carries supervisor_* events — an unattended night's crash/hang/
    # restart/poison story reconstructs from the log alone.
    sup_events = [e for e in events
                  if str(e.get("ev", "")).startswith("supervisor_")]
    supervisor = None
    if sup_events:
        def _n(kind):
            return len([e for e in sup_events if e.get("ev") == kind])

        exits = [e for e in sup_events
                 if e.get("ev") == "supervisor_child_exit"]
        supervisor = {
            "launches": _n("supervisor_launch"),
            "restarts": _n("supervisor_restart"),
            "crashes": len([e for e in exits
                            if not e.get("hang") and e.get("rc") != 0]),
            "hangs": _n("supervisor_timeout"),
            "poisoned": [e.get("path") for e in sup_events
                         if e.get("ev") == "supervisor_poison"],
            "gave_up": _n("supervisor_giveup") > 0,
            "completed": _n("supervisor_done") > 0,
            "last_round": max((e.get("last_round", -1) for e in exits),
                              default=None),
        }

    # Open-world churn (--churn, federated/participation.py,
    # docs/service.md §population churn): the population timeline rebuilt
    # entirely from the relayed churn_* events + the end-of-run
    # conservation audit + the run header — the same log-alone
    # reproducibility drill as the participation section
    # (tests/test_service.py compares these totals against the live
    # PopulationManager's counters).
    join_events = [e for e in events if e.get("ev") == "churn_join"]
    depart_events = [e for e in events if e.get("ev") == "churn_depart"]
    short_events = [e for e in events if e.get("ev") == "cohort_short"]
    compact_events = [e for e in events
                      if e.get("ev") == "rows_compacted"]
    churn_audit_ev = next((e for e in reversed(events)
                           if e.get("ev") == "churn_audit"), None)
    churn = None
    if (join_events or depart_events or churn_audit_ev
            or run_info.get("churn")):
        # events land in churn-clock order (the sampler steps the clock
        # in-order on the main thread), so file order IS time order
        pop_curve = [(e.get("churn_round"), e.get("population"))
                     for e in events
                     if e.get("ev") in ("churn_join", "churn_depart")]
        pops = [pv for _, pv in pop_curve
                if isinstance(pv, (int, float))]
        churn = {
            "schedule": run_info.get("churn"),
            "joins": sum(len(e.get("clients", []))
                         for e in join_events),
            "departs": sum(len(e.get("clients", []))
                           for e in depart_events),
            "join_rounds": len(join_events),
            "depart_rounds": len(depart_events),
            "cohort_short": len(short_events),
            "rows_retired": sum(e.get("rows", 0) for e in events
                                if e.get("ev") == "rows_retired"),
            "compactions": len(compact_events),
            "rows_moved": sum(e.get("moved", 0)
                              for e in compact_events),
            "holes_reclaimed": sum(e.get("holes_reclaimed", 0)
                                   for e in compact_events),
            "population_first": pops[0] if pops else None,
            "population_last": pops[-1] if pops else None,
            "population_min": min(pops) if pops else None,
            "population_max": max(pops) if pops else None,
            # the acceptance audit: registered == active + departed +
            # quarantined, cross-checked against the running counters
            "audit": ({k: v for k, v in churn_audit_ev.items()
                       if k not in ("ev", "t")}
                      if churn_audit_ev else None),
        }

    # Serving replica (scripts/serve.py, docs/service.md §serving):
    # rebuilt from <serve_dir>/serving.jsonl — point obs_report at that
    # file directly (load_events takes a bare jsonl path). The monotone
    # model_version check replays the chronological swap/answer stream,
    # which is the e2e acceptance property.
    serve_start = next((e for e in events
                        if e.get("ev") == "serving_start"), None)
    serve_stop = next((e for e in reversed(events)
                       if e.get("ev") == "serving_stop"), None)
    serve_swaps = [e for e in events if e.get("ev") == "serving_swap"]
    answers = [e for e in events if e.get("ev") == "serving_answer"]
    serving = None
    if serve_start or serve_swaps or answers:
        by_op: Dict[str, int] = {}
        for e in answers:
            op = str(e.get("op"))
            by_op[op] = by_op.get(op, 0) + 1
        stamps = [e["t"] for e in answers if "t" in e]
        span = (max(stamps) - min(stamps)) if len(stamps) >= 2 else None
        seq = [e.get("model_version") for e in events
               if e.get("ev") in ("serving_swap", "serving_answer")
               and isinstance(e.get("model_version"), int)]
        lat = [e["latency_ms"] for e in answers
               if isinstance(e.get("latency_ms"), (int, float))]
        serving = {
            "owner": (serve_start or {}).get("owner"),
            "checkpoint_path": (serve_start or {}).get(
                "checkpoint_path"),
            "answers": len(answers),
            "errors": len([e for e in answers if "error" in e]),
            "by_op": by_op,
            "qps": _fin(round(len(answers) / span, 3)
                        if span else None),
            "latency_ms_p50": _fin(_pct(lat, 0.5)),
            "latency_ms_p90": _fin(_pct(lat, 0.9)),
            "swaps": len(serve_swaps),
            "swap_versions": [e.get("model_version")
                              for e in serve_swaps],
            "load_ms_p50": _fin(_pct([e["load_ms"] for e in serve_swaps
                                      if "load_ms" in e], 0.5)),
            "versions_monotone": all(a <= b for a, b
                                     in zip(seq, seq[1:])),
            "first_version": seq[0] if seq else None,
            "final_version": seq[-1] if seq else None,
            "clean_stop": serve_stop is not None,
            # the replica's own terminal counters, kept alongside the
            # reconstruction so a disagreement is visible in the tail
            "reported": ({k: serve_stop.get(k) for k in
                          ("answered", "errors", "swaps",
                           "model_version")}
                         if serve_stop else None),
        }

    return {
        "log_rounds": len(rounds),
        "partial_rounds": len([e for e in events
                               if e.get("ev") == "round_partial"]),
        "run_complete": run_end is not None,
        "mode": run_info.get("mode"),
        "grad_size": run_info.get("grad_size"),
        "guards": run_info.get("guards"),
        "backend": run_info.get("backend"),
        "wall_s": _fin(round(wall, 3) if wall is not None else None),
        "rounds_per_sec": _fin(round(rps, 3) if rps else None),
        "dispatch_ms_p50": _fin(_pct(span_list("dispatch_ms"), 0.5)),
        "dispatch_ms_p90": _fin(_pct(span_list("dispatch_ms"), 0.9)),
        "compute_ms_p50": _fin(_pct(span_list("compute_ms"), 0.5)),
        "drain_fetch_ms_p50": _fin(_pct(span_list("drain_fetch_ms"), 0.5)),
        "dispatch_to_drain_ms_p50": _fin(
            _pct(span_list("dispatch_to_drain_ms"), 0.5)),
        "occupancy_mean": _fin(
            round(sum(span_list("occupancy")) / len(span_list("occupancy")),
                  2) if span_list("occupancy") else None),
        "drains": len(drains),
        "guard_trips": len(trips),
        "tripped_rounds": tripped_rounds,
        "rollbacks": len(rollbacks),
        "rollback_rounds": [e["round"] for e in rollbacks],
        "fatal": len(fatals) > 0,
        "checkpoints": len([e for e in events if e.get("ev") == "checkpoint"]),
        "resumes": len([e for e in events if e.get("ev") == "resume"]),
        "epochs": len([e for e in events if e.get("ev") == "epoch"]),
        "mean_participants": _fin(_mean(
            [e["cohort"]["participants"] for e in rounds
             if "cohort" in e])),
        "mean_staleness": _fin(_mean(
            [e["cohort"]["staleness_mean"] for e in rounds
             if "staleness_mean" in e.get("cohort", {})])),
        "max_staleness": _fin(max(
            (e["cohort"]["staleness_max"] for e in rounds
             if "staleness_max" in e.get("cohort", {})), default=None)),
        "mean_update_nnz": _fin(metric_mean("update_nnz")),
        "mean_topk_threshold": _fin(metric_mean("topk_threshold")),
        "mean_error_norm": _fin(metric_mean("error_norm")),
        # EF carries of the quantized collective legs
        # (docs/compressed_collectives.md). Schema-version tolerant by
        # construction: round events carry metrics as a name-keyed dict,
        # so a v1 log (11-field schema, no dres_norm slot) simply yields
        # None here instead of failing to parse.
        "collective_plan": run_info.get("collective_plan"),
        "mean_qres_norm": _fin(metric_mean("qres_norm")),
        "mean_dres_norm": _fin(metric_mean("dres_norm")),
        "wire_bytes_per_round": sum(
            row["bytes_per_round"] for leg, row in ledger.items()
            if leg != "client_uplink") or None,
        "mean_loss": _fin(_mean([e["loss"] for e in rounds
                                 if isinstance(e.get("loss"), float)
                                 and math.isfinite(e["loss"])])),
        "participation": participation,
        "async": async_info,
        "host_offload": host_offload,
        "ledger": ledger_totals,
        "mesh": run_info.get("mesh"),
        # continuous-observability additions (schema v3 + watch plane)
        "metric_schema_len": len(run_info.get("schema", []) or []) or None,
        "alerts": alerts,
        "trace_captures": trace_captures,
        "supervisor": supervisor,
        # always-on federation service (docs/service.md)
        "churn": churn,
        "serving": serving,
        "histograms": {
            "update": _hist_summary(rounds, "update_hist_"),
            "error": _hist_summary(rounds, "error_hist_"),
        },
    }


def render(events: List[dict], out=None) -> Dict[str, Any]:
    # resolve stdout at CALL time, not import time: a default bound to
    # sys.stdout freezes whatever stream was installed when the module
    # was first imported (e.g. one pytest test's capture object — closed
    # by the time another test calls render)
    out = out if out is not None else sys.stdout
    s = summarize(events)
    rounds = [e for e in events if e.get("ev") == "round"]
    run_info = next((e for e in events if e.get("ev") == "run_start"), {})
    p = lambda *a: print(*a, file=out)  # noqa: E731

    p("# Run summary")
    p(f"mode={s['mode']} grad_size={s['grad_size']} "
      f"guards={s['guards']} backend={s['backend']} "
      f"entrypoint={run_info.get('entrypoint')}")
    fate = ("completed" if s["run_complete"]
            else "DID NOT complete — crashed, killed, or still running")
    partial = (f", {s['partial_rounds']} dispatched-but-never-drained"
               if s["partial_rounds"] else "")
    p(f"rounds drained: {s['log_rounds']}{partial}  (run {fate})")
    if s["rounds_per_sec"]:
        p(f"wall span {s['wall_s']} s  ~{s['rounds_per_sec']} rounds/s "
          "(host-side, includes drain stalls)")

    p("\n## Round lifecycle (ms)")
    p("| span | p50 | p90 |")
    p("|---|---|---|")
    for key, label in (("dispatch_ms", "dispatch (LR+client+server+seal)"),
                       ("compute_ms", "device compute (window wait)"),
                       ("drain_fetch_ms", "drain fetch"),
                       ("dispatch_to_drain_ms", "dispatch -> drain")):
        vals = [e[key] for e in rounds if key in e]
        p(f"| {label} | {_pct(vals, 0.5)} | {_pct(vals, 0.9)} |")
    p(f"in-flight window occupancy at dispatch: mean {s['occupancy_mean']}"
      f", drains: {s['drains']}")
    if s["mean_participants"] is not None:
        stale = (f", staleness mean {s['mean_staleness']:.1f} / max "
                 f"{s['max_staleness']} rounds"
                 if s["mean_staleness"] is not None else "")
        p(f"cohort: mean {s['mean_participants']:.1f} participants/round"
          f"{stale}")

    if s["ledger"]:
        p("\n## Compression ledger (static legs x drained rounds)")
        if s["collective_plan"]:
            p(f"collective plan: {s['collective_plan']} "
              "(docs/compressed_collectives.md)")
        p("| leg | collective | dtype | bytes/round | total bytes |")
        p("|---|---|---|---|---|")
        for leg, row in s["ledger"].items():
            p(f"| {leg} | {row['collective']} | {row.get('dtype') or '?'} | "
              f"{row['bytes_per_round']:,} | {row['total_bytes']:,} |")
        if s["wire_bytes_per_round"]:
            p(f"mesh wire legs total: {s['wire_bytes_per_round']:,} "
              "bytes/round (client_uplink excluded — per-client, not a "
              "mesh collective)")
        # ici-vs-dcn wire split of the per-mesh-axis legs
        # (docs/multihost.md): intra-host (ICI) vs cross-host (DCN)
        # bytes, the quantity a dcn:int8 plan exists to shrink
        split = {"ici": 0, "dcn": 0}
        for leg, row in s["ledger"].items():
            for ax, lvl in (row.get("bytes_per_axis") or {}).items():
                split[lvl.get("placement", "ici")] += lvl["bytes_per_round"]
        if split["ici"] or split["dcn"]:
            mesh = s.get("mesh") or {}
            axes = ", ".join(
                f"{a['name']}={a['size']} ({a['placement']})"
                for a in mesh.get("axes", []))
            p(f"per-axis wire split: ICI {split['ici']:,} bytes/round, "
              f"DCN {split['dcn']:,} bytes/round"
              + (f" — mesh {axes}, {mesh.get('process_count', 1)} "
                 f"process(es)" if axes else ""))
    if s["mean_update_nnz"] is not None:
        p(f"runtime compression: mean resolved k "
          f"{s['mean_update_nnz']:.1f}, mean |threshold| "
          f"{s['mean_topk_threshold']:.3g}, mean error-carry norm "
          f"{s['mean_error_norm']:.3g}")
    if s["mean_qres_norm"] or s["mean_dres_norm"]:
        dres = (f"{s['mean_dres_norm']:.3g}"
                if isinstance(s["mean_dres_norm"], (int, float))
                else "n/a (pre-dres schema log)")
        p(f"quantized-collective EF carries: mean qres (uplink) "
          f"{s['mean_qres_norm'] or 0:.3g}, mean dres (downlink) {dres}")
    hists = s.get("histograms") or {}
    if hists.get("update") or hists.get("error"):
        p("\n## Update / error-carry magnitude histograms (schema v3)")
        p("log10-magnitude bins (docs/observability.md: bin i spans "
          "10^(-12+2i) .. 10^(-10+2i); last bin holds overflow + "
          "non-finite), mean counts over drained rounds:")
        for key, label in (("update", "emitted update"),
                           ("error", "error carry")):
            h = hists.get(key)
            if h:
                counts = " ".join(f"{v:g}" for v in h["mean_counts"])
                p(f"- {label}: [{counts}]  (modal bin {h['modal_bin']})")

    al = s.get("alerts") or {}
    if al.get("count") or (al.get("rules") is not None):
        p("\n## Watch / alert history (docs/observability.md "
          "§watch plane)")
        if al.get("rules") is not None:
            p(f"{len(al['rules'])} rules armed")
        if al.get("count"):
            p(f"{al['count']} alert(s); worst rule: {al['worst_rule']} "
              f"({al['worst_rule_count']} fires)")
            for e in (x for x in events if x.get("ev") == "watch_alert"):
                extra = ""
                if e.get("action") == "trace":
                    extra = (" -> trace requested"
                             if e.get("trace_requested")
                             else " -> trace (no tracer)")
                elif e.get("action") == "checkpoint":
                    extra = " -> checkpoint forced"
                p(f"- ALERT at round {e.get('round')}: {e.get('rule')} "
                  f"(value {e.get('value')}, bound {e.get('bound')})"
                  f"{extra}")
        else:
            p("no alerts fired")
    for cap in s.get("trace_captures") or []:
        p(f"- trace captured: rounds {cap['round_start']}-"
          f"{cap['round_until']} -> {cap['dir']}")

    part = s["participation"]
    if (part.get("client_fault") or part.get("cohort_target") is not None
            or part.get("dropped") or part.get("landed")):
        p("\n## Participation (docs/fault_tolerance.md §client faults)")
        if part.get("cohort_target") is not None:
            p(f"cohort target: {part['cohort_target']} clients/round "
              f"(--participation {part.get('participation')}, "
              f"{part.get('sampling')} sampling)")
        if part.get("client_fault"):
            p(f"fault schedule: {part['client_fault'].get('spec')}")
        p(f"faults: {part['dropped']} dropped "
          f"({part['requeued']} requeued, {part['abandoned']} abandoned), "
          f"{part['slow']} stragglers ({part['landed']} landed, "
          f"{part['expired']} expired), {part['corrupt']} corrupt "
          f"({part['quarantined']} clients quarantined)"
          + (f", {part['fault_skips']} all-fault rounds kept whole"
             if part["fault_skips"] else ""))
        if part["staleness_hist"]:
            hist = ", ".join(
                f"Δ={d}: {n}" for d, n in sorted(
                    part["staleness_hist"].items(), key=lambda kv:
                    int(kv[0])))
            w = part.get("landed_weight_mean")
            p(f"late-landing staleness histogram: {hist}"
              + (f" (mean landing weight {w:.3g}; "
                 f"w(Δ)={part.get('staleness_decay')}**Δ)"
                 if isinstance(w, (int, float)) else ""))
        if part["retry_ladder"]:
            ladder = ", ".join(
                f"attempt {a}: {n}" for a, n in sorted(
                    part["retry_ladder"].items(),
                    key=lambda kv: int(kv[0])))
            p(f"drop-requeue retry ladder: {ladder}")

    asy = s.get("async")
    if asy:
        p("\n## Async buffered federation (docs/async.md)")
        p(f"buffer K={asy.get('buffer')}, "
          f"staleness decay {asy.get('staleness_decay')}")
        p(f"{asy['dispatches']} dispatch(es) -> {asy['folds']} fold(s), "
          f"{asy['folded_contributions']} contribution(s) folded, "
          f"server version {asy['server_version']}")
        p(f"buffer depth mean {asy['depth_mean']} / max "
          f"{asy['depth_max']}")
        if asy.get("staleness_hist"):
            hist = ", ".join(
                f"D={d}: {n}" for d, n in sorted(
                    asy["staleness_hist"].items(),
                    key=lambda kv: int(kv[0])))
            p(f"exact staleness at fold ({asy['stale_folds']} stale, "
              f"mean weight {asy['fold_weight_mean']}): {hist}")
        if asy.get("masked") or asy.get("expired"):
            p(f"{asy.get('masked', 0)} contribution(s) masked non-finite "
              f"at fold, {asy.get('expired', 0)} expired unfolded at "
              "run end")

    ho = s.get("host_offload")
    if ho:
        p("\n## Host offload (docs/host_offload.md)")
        geom = ""
        if ho.get("rows_per_round") and ho.get("slot_bytes"):
            geom = (f", streaming {ho['rows_per_round']} row slots/round x "
                    f"{ho['slot_bytes'] / 2**20:.2f} MiB/slot")
        p(f"placement tier: {ho.get('tier')}{geom}")
        total = ho["prefetch_hits"] + ho["prefetch_misses"]
        if total or ho["prefetch_off"]:
            rate = (f"{ho['prefetch_hits'] / total:.0%}" if total
                    else "n/a")
            p(f"cohort prefetch: {ho['prefetch_hits']} hits / "
              f"{ho['prefetch_misses']} misses (hit rate {rate})"
              + (f", {ho['prefetch_off']} rounds with prefetch OFF"
                 if ho["prefetch_off"] else ""))
        if ho.get("gather_ms_p50") is not None:
            io = (f" (worker read+upload p50 {ho['gather_io_ms_p50']} ms)"
                  if ho.get("gather_io_ms_p50") is not None else "")
            p(f"gather p50 {ho['gather_ms_p50']} ms on the dispatch "
              f"path{io}")
        if ho.get("scatter_ms_p50") is not None:
            io = (f" (worker write p50 {ho['scatter_io_ms_p50']} ms, "
                  "overlapped with the next round's compute)"
                  if ho.get("scatter_io_ms_p50") is not None else "")
            p(f"scatter dispatch p50 {ho['scatter_ms_p50']} ms{io}")
        cfg = ho.get("io_config")
        if cfg:
            inj = (f", injection {cfg['inject']}" if cfg.get("inject")
                   else "")
            cks = (", checksums ON"
                   + (f" + scrub {cfg.get('scrub_rows')} rows/round"
                      if cfg.get("scrub_rows") else "")
                   if cfg.get("checksums") else ", checksums OFF")
            p(f"I/O plane: queue bound {cfg.get('queue_bound')} ops, "
              f"{cfg.get('retries')} retries x "
              f"{cfg.get('backoff_ms')} ms backoff, watchdog deadline "
              f"{cfg.get('deadline_ms')} ms, row quarantine after "
              f"{cfg.get('quarantine_after')} failed attempts{cks}{inj}")
        if (ho.get("io_retries") or ho.get("io_errors")
                or ho.get("rows_quarantined") or ho.get("io_fatal")
                or ho.get("rows_corrupt")):
            p("\n### Storage-fault ladder "
              "(docs/fault_tolerance.md §storage faults)")
            p(f"{ho.get('io_retries', 0)} retried attempt(s), "
              f"{ho.get('io_errors', 0)} exhausted op(s), "
              f"{ho.get('rows_quarantined', 0)} row(s) quarantined"
              + (f" at rounds {ho['quarantine_rounds']}"
                 if ho.get("quarantine_rounds") else ""))
            if ho.get("rows_corrupt") or ho.get("scrub_rows"):
                srcs = ", ".join(
                    f"{n} via {s}" for s, n in
                    (ho.get("repair_sources") or {}).items())
                inj = (ho.get("injected") or {})
                inj_txt = ""
                if inj.get("flip") or inj.get("storn"):
                    inj_txt = (f"; injected silent faults: "
                               f"{inj.get('flip', 0)} flip / "
                               f"{inj.get('storn', 0)} silent-torn")
                p(f"silent corruption (§silent corruption): "
                  f"{ho.get('rows_corrupt', 0)} detected, "
                  f"{ho.get('rows_repaired', 0)} repaired"
                  + (f" ({srcs})" if srcs else "")
                  + f"; scrub verified {ho.get('scrub_rows', 0)} "
                    f"row-reads, {ho.get('scrub_mismatch', 0)} "
                    f"mismatch(es){inj_txt}")
            for e in (x for x in events
                      if x.get("ev") == "row_corrupt"):
                p(f"- row {e.get('row')} member {e.get('member')} "
                  f"CORRUPT at round {e.get('round')} "
                  f"(detected on {e.get('where')})")
            for e in (x for x in events
                      if x.get("ev") == "row_repaired"):
                p(f"- row {e.get('row')} member {e.get('member')} "
                  f"repaired at round {e.get('round')} "
                  f"(source: {e.get('source')})")
            for e in (x for x in events
                      if x.get("ev") == "row_quarantined"):
                p(f"- row {e.get('row')} quarantined at round "
                  f"{e.get('round')} ({e.get('op')}: {e.get('cause')})")
            if ho.get("io_fatal"):
                p(f"- TERMINAL: {ho['io_fatal']}")

    sup = s.get("supervisor")
    if sup:
        p("\n## Supervisor (scripts/supervise.py, "
          "docs/fault_tolerance.md §self-healing supervisor)")
        fate = ("run completed" if sup.get("completed")
                else "GAVE UP (restart budget exhausted)"
                if sup.get("gave_up") else "still running / killed")
        p(f"{sup['launches']} launch(es), {sup['restarts']} restart(s) "
          f"({sup['crashes']} crash(es), {sup['hangs']} hang(s)) — "
          f"{fate}; last heartbeat round {sup.get('last_round')}")
        for e in (x for x in events
                  if x.get("ev") == "supervisor_timeout"):
            p(f"- HANG: no heartbeat for {e.get('silent_s')}s "
              f"(last round {e.get('last_round')}) -> SIGKILL")
        for e in (x for x in events
                  if x.get("ev") == "supervisor_restart"):
            p(f"- restart ({e.get('reason')}) after "
              f"{e.get('backoff_s')}s backoff")
        for path in sup.get("poisoned") or []:
            p(f"- POISON checkpoint excluded: {path}")

    ch = s.get("churn")
    if ch:
        p("\n## Open-world churn (--churn, docs/service.md)")
        sched = ch.get("schedule")
        if sched:
            p(f"schedule: {sched.get('spec')} — join {sched.get('join')}"
              f"/round, depart {sched.get('depart')}/round, "
              f"init {sched.get('init')}, seed {sched.get('seed')}"
              + (f", compact after {sched.get('compact')} hole(s)"
                 if sched.get("compact") else ""))
        p(f"{ch['joins']} join(s) over {ch['join_rounds']} round(s), "
          f"{ch['departs']} depart(s) over {ch['depart_rounds']} "
          f"round(s); live population {ch['population_first']} -> "
          f"{ch['population_last']} "
          f"(min {ch['population_min']} / max {ch['population_max']})")
        if ch["cohort_short"]:
            p(f"{ch['cohort_short']} cohort(s) clamped below the "
              "participation target (churn shortfall, counted — "
              "never silent)")
        if ch["rows_retired"] or ch["compactions"]:
            p(f"row lifecycle: {ch['rows_retired']} row(s) retired at "
              f"drain barriers, {ch['compactions']} compaction(s) "
              f"({ch['rows_moved']} row(s) moved, "
              f"{ch['holes_reclaimed']} hole(s) reclaimed)")
        a = ch.get("audit")
        if a:
            p(f"conservation: registered {a.get('registered')} == "
              f"active {a.get('active')} + departed {a.get('departed')} "
              f"+ quarantined {a.get('quarantined')} -> "
              f"{'OK' if a.get('ok') else 'BROKEN'}"
              + (f"  ({a.get('idle_rounds')} idle churn round(s) spun "
                 "waiting for joiners)" if a.get("idle_rounds") else ""))
        else:
            p("no churn_audit event — run crashed, was killed, or is "
              "still running")

    sv = s.get("serving")
    if sv:
        p("\n## Serving replica (scripts/serve.py, docs/service.md)")
        p(f"owner {sv.get('owner')} tracking "
          f"{sv.get('checkpoint_path') or '?'}")
        ops = ", ".join(f"{op}: {n}"
                        for op, n in sorted(sv["by_op"].items()))
        p(f"{sv['answers']} answer(s), {sv['errors']} error(s)"
          + (f" — {ops}" if ops else ""))
        if sv.get("qps") or sv.get("latency_ms_p50") is not None:
            p(f"throughput ~{sv.get('qps')} answers/s, latency p50 "
              f"{sv.get('latency_ms_p50')} ms / p90 "
              f"{sv.get('latency_ms_p90')} ms")
        mono = ("monotone" if sv["versions_monotone"]
                else "NON-MONOTONE (BROKEN)")
        p(f"{sv['swaps']} hot swap(s) "
          f"(weights load p50 {sv.get('load_ms_p50')} ms): "
          f"model_version {sv.get('first_version')} -> "
          f"{sv.get('final_version')}, {mono} across swaps")
        if sv["swap_versions"]:
            p(f"- swap versions: {sv['swap_versions']}")
        if not sv["clean_stop"]:
            p("no serving_stop event — replica crashed, was killed, or "
              "is still serving")

    p("\n## Guard / rollback history")
    if not s["guards"]:
        p("guards were OFF for this run")
    trips = [e for e in events if e.get("ev") == "guard_trip"]
    if trips or s["tripped_rounds"]:
        for e in trips:
            p(f"- guard TRIP at round {e['round']} "
              f"(trip {e.get('trip')}, consecutive {e.get('consecutive')})")
        for e in (x for x in events if x.get("ev") == "rollback"):
            p(f"- ROLLBACK to last-good snapshot at round {e['round']} "
              f"({e.get('consecutive')} consecutive trips)")
        for e in (x for x in events if x.get("ev") == "guard_fatal"):
            p(f"- FATAL guard escalation at round {e['round']}")
        p(f"tripped rounds (from trip events + drained verdicts): "
          f"{s['tripped_rounds']}")
    else:
        p("no guard trips recorded")

    other = [e for e in events if e.get("ev") in ("checkpoint", "resume",
                                              "epoch")]
    if other:
        p("\n## Lifecycle events")
        for e in other:
            extra = {k: v for k, v in e.items() if k not in ("ev", "t")}
            p(f"- {e['ev']}: {extra}")
    return s


class LiveReader:
    """Incremental torn-tail-safe JSONL reader for a file being appended
    to by a LIVE run. Unlike ``read_events`` (which STOPS at a torn
    trailing line — correct for a dead run's log), this reader buffers an
    incomplete trailing line and resumes the moment its newline lands, so
    ``--follow`` never drops the round that was mid-write at poll time.
    A COMPLETE line that still fails to parse (disk corruption) is
    skipped, never fatal."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._buf = ""

    def poll(self) -> List[dict]:
        events: List[dict] = []
        try:
            with open(self.path) as f:
                f.seek(self._pos)
                data = f.read()
                self._pos = f.tell()
        except OSError:
            return events
        self._buf += data
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "ev" in rec:
                events.append(rec)
        return events


def _fmt(v, nd=3):
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return "-" if v is None else str(v)


def follow(path: str, out=None, interval: float = 2.0,
           tail_rounds: int = 12, max_iters: int = 0,
           clear: bool | None = None) -> int:
    """Live-tail a run's event log: a refreshing table of the most recent
    drained rounds + active watch alerts, re-rendered as flushed lines
    land. Exits when the run_end event arrives (prints the final machine
    tail) or on Ctrl-C. ``max_iters`` bounds the poll loop for tests
    (0 = until run_end/interrupt)."""
    import time as _time

    out = out if out is not None else sys.stdout
    if os.path.isdir(path):
        path = os.path.join(path, "telemetry.jsonl")
    if clear is None:
        clear = getattr(out, "isatty", lambda: False)()
    reader = LiveReader(path)
    events: List[dict] = []
    iters = 0
    ended = False
    p = lambda *a: print(*a, file=out)  # noqa: E731
    try:
        while True:
            fresh = reader.poll()
            events.extend(fresh)
            if fresh or iters == 0:
                if clear:
                    out.write("\x1b[2J\x1b[H")
                run_info = next((e for e in events
                                 if e.get("ev") == "run_start"), {})
                rounds = [e for e in events if e.get("ev") == "round"]
                alerts = [e for e in events
                          if e.get("ev") == "watch_alert"]
                p(f"# obs_report --follow {path}")
                p(f"mode={run_info.get('mode')} "
                  f"backend={run_info.get('backend')} "
                  f"rounds drained: {len(rounds)}  alerts: {len(alerts)}")
                p("| round | loss | guard | k | threshold | err norm | "
                  "dispatch ms | occ |")
                p("|---|---|---|---|---|---|---|---|")
                for e in rounds[-tail_rounds:]:
                    m = e.get("metrics") or {}
                    guard = e.get("guard_ok")
                    p(f"| {e.get('round')} | {_fmt(e.get('loss'))} | "
                      f"{'ok' if guard in (True, None) else 'TRIP'} | "
                      f"{_fmt(m.get('update_nnz'), 6)} | "
                      f"{_fmt(m.get('topk_threshold'))} | "
                      f"{_fmt(m.get('error_norm'))} | "
                      f"{_fmt(e.get('dispatch_ms'))} | "
                      f"{_fmt(e.get('occupancy'))} |")
                recent = alerts[-6:]
                if recent:
                    p("active alerts:")
                    for a in recent:
                        p(f"- round {a.get('round')}: {a.get('rule')} "
                          f"(value {a.get('value')})")
                for e in fresh:
                    if e.get("ev") == "trace_captured":
                        p(f"trace captured: rounds {e.get('round_start')}"
                          f"-{e.get('round_until')} -> {e.get('dir')}")
                if hasattr(out, "flush"):
                    out.flush()
            if any(e.get("ev") == "run_end" for e in fresh):
                ended = True
                break
            iters += 1
            if max_iters and iters >= max_iters:
                break
            _time.sleep(interval)
    except KeyboardInterrupt:
        pass
    if events:
        p(json.dumps(summarize(events), allow_nan=False))
    return 0 if (ended or events) else 2


# the span/metric keys the A/B delta table compares (numeric, flat)
_COMPARE_KEYS = (
    "log_rounds", "rounds_per_sec", "dispatch_ms_p50", "compute_ms_p50",
    "drain_fetch_ms_p50", "dispatch_to_drain_ms_p50", "occupancy_mean",
    "mean_loss", "mean_update_nnz", "mean_topk_threshold",
    "mean_error_norm", "wire_bytes_per_round", "guard_trips",
)


def compare(path_a: str, path_b: str, out=None) -> Dict[str, Any]:
    """Span/metric delta table between two completed run logs (A/B legs:
    e.g. a feature-flag bench pair). Deltas are B - A (and B/A - 1 where
    A is nonzero); the machine tail carries both summaries + the
    deltas."""
    out = out if out is not None else sys.stdout
    a, b = summarize(load_events(path_a)), summarize(load_events(path_b))
    p = lambda *x: print(*x, file=out)  # noqa: E731
    p(f"# Run comparison\nA: {path_a}\nB: {path_b}")
    p("| metric | A | B | delta | B/A |")
    p("|---|---|---|---|---|")
    deltas: Dict[str, Any] = {}
    rows = _COMPARE_KEYS + ("alerts",)
    for key in rows:
        va = a["alerts"]["count"] if key == "alerts" else a.get(key)
        vb = b["alerts"]["count"] if key == "alerts" else b.get(key)
        if not isinstance(va, (int, float)) \
                and not isinstance(vb, (int, float)):
            continue
        delta = (vb - va) if isinstance(va, (int, float)) \
            and isinstance(vb, (int, float)) else None
        ratio = (vb / va if isinstance(delta, (int, float)) and va
                 else None)
        deltas[key] = delta
        p(f"| {key} | {_fmt(va, 6)} | {_fmt(vb, 6)} | "
          f"{_fmt(delta, 4)} | {_fmt(ratio, 4)} |")
    return {"a": a, "b": b, "delta": deltas}


def load_fleet_events(path: str) -> List[dict]:
    """Like ``load_events`` but a directory resolves to the
    orchestrator's ``fleet_events.jsonl`` (scripts/orchestrate.py)."""
    if os.path.isdir(path):
        path = os.path.join(path, "fleet_events.jsonl")
    return [e for e in read_events(path)
            if isinstance(e, dict) and "ev" in e]


def summarize_fleet(events: List[dict]) -> Dict[str, Any]:
    """Reconstruct a packed fleet (docs/packing.md) from the
    orchestrator's JSONL alone: one row per tenant (admission time,
    attempts, restarts, rounds, terminal state) plus the aggregate
    rounds/sec and the conservation audit
    ``admitted == finished + gave_up + in_flight``."""
    start = next((e for e in events if e.get("ev") == "fleet_start"), {})
    done = next((e for e in reversed(events)
                 if e.get("ev") == "fleet_done"), None)
    tenants: Dict[int, Dict[str, Any]] = {}

    def trow(i: int) -> Dict[str, Any]:
        return tenants.setdefault(int(i), {
            "label": None, "admit_t": None, "starts": 0, "attempts": 0,
            "restarts": 0, "rounds": 0, "last_round": -1,
            "progress_t": [], "throttles": 0, "finished": False,
            "gave_up": False, "poison": 0, "state": "in_flight",
        })

    for e in events:
        ev = e.get("ev", "")
        if not ev.startswith("tenant_") or "tenant" not in e:
            continue
        row = trow(e["tenant"])
        if e.get("label") is not None:
            row["label"] = e["label"]
        if ev == "tenant_admit":
            row["admit_t"] = e.get("t")
        elif ev == "tenant_start":
            row["starts"] += 1
            row["attempts"] = max(row["attempts"],
                                  int(e.get("attempt", row["starts"])))
        elif ev == "tenant_progress":
            row["last_round"] = max(row["last_round"],
                                    int(e.get("round", -1)))
            row["rounds"] = max(row["rounds"], int(e.get("beats", 0)))
            if e.get("t") is not None:
                row["progress_t"].append(e["t"])
        elif ev == "tenant_exit":
            row["last_round"] = max(row["last_round"],
                                    int(e.get("last_round", -1)))
        elif ev == "tenant_restart":
            row["restarts"] += 1
        elif ev == "tenant_throttle":
            row["throttles"] += 1
        elif ev == "tenant_poison":
            row["poison"] += 1
        elif ev == "tenant_finish":
            row["finished"] = True
            row["state"] = "finished"
            if e.get("rounds") is not None:
                row["rounds"] = max(row["rounds"], int(e["rounds"]))
        elif ev == "tenant_giveup":
            row["gave_up"] = True
            row["state"] = "gave_up"
    admitted = sum(1 for r in tenants.values()
                   if r["admit_t"] is not None)
    finished = sum(1 for r in tenants.values() if r["finished"])
    gave_up = sum(1 for r in tenants.values() if r["gave_up"])
    in_flight = admitted - finished - gave_up
    total_rounds = sum(r["rounds"] for r in tenants.values())
    wall = None
    if done is not None and start.get("t") is not None:
        wall = done["t"] - start["t"]
    out: Dict[str, Any] = {
        "tenants_declared": start.get("tenants"),
        "max_concurrent": start.get("max_concurrent"),
        "cache_dir": start.get("cache_dir"),
        "warm_admission": start.get("warm_admission"),
        "admitted": admitted,
        "finished": finished,
        "gave_up": gave_up,
        "in_flight": in_flight,
        "restarts": sum(r["restarts"] for r in tenants.values()),
        "total_rounds": total_rounds,
        "wall_s": round(wall, 3) if wall is not None else None,
        "rounds_per_sec": (round(total_rounds / wall, 4)
                           if wall else None),
        # the conservation audit the fleet log must satisfy: every
        # admitted tenant is terminal or still in flight, nothing
        # double-counted, nothing lost
        "conservation_ok": admitted == finished + gave_up + in_flight
        and in_flight >= 0,
        "tenants": {str(i): {k: v for k, v in row.items()
                             if k != "progress_t"}
                    for i, row in sorted(tenants.items())},
    }
    if done is not None:
        # the orchestrator's own aggregate, kept alongside the
        # reconstruction so a disagreement is visible in the JSON tail
        out["reported"] = {k: done.get(k) for k in
                           ("admitted", "finished", "gave_up", "restarts",
                            "total_rounds", "wall_s", "rounds_per_sec")}
    return out


def render_fleet(events: List[dict], out=None) -> Dict[str, Any]:
    """Human-readable fleet report (per-tenant round table + aggregate
    rounds/sec) from the orchestrator JSONL alone; returns the
    ``summarize_fleet`` dict for the machine-readable tail."""
    out = out or sys.stdout
    s = summarize_fleet(events)
    w = lambda line="": print(line, file=out)  # noqa: E731
    w("# Fleet summary (scripts/orchestrate.py, docs/packing.md)")
    w()
    w(f"declared tenants: {s['tenants_declared']}  "
      f"max_concurrent: {s['max_concurrent']}  "
      f"warm_admission: {s['warm_admission']}")
    if s.get("cache_dir"):
        w(f"shared compile cache: {s['cache_dir']}")
    w()
    w("## Fleet tenants")
    w()
    w("| tenant | label | attempts | restarts | rounds | last round "
      "| throttles | state |")
    w("|---|---|---|---|---|---|---|---|")
    for i, row in s["tenants"].items():
        w(f"| {i} | {row['label'] or '?'} | {row['attempts']} "
          f"| {row['restarts']} | {row['rounds']} | {row['last_round']} "
          f"| {row['throttles']} | {row['state']} |")
    w()
    wall = s["wall_s"]
    rps = s["rounds_per_sec"]
    w(f"aggregate: {s['total_rounds']} rounds"
      + (f" in {wall:.1f}s = {rps:.3f} rounds/s" if wall else
         " (no fleet_done yet — fleet still running?)"))
    w(f"conservation: admitted {s['admitted']} == finished "
      f"{s['finished']} + gave_up {s['gave_up']} + in_flight "
      f"{s['in_flight']} -> {'OK' if s['conservation_ok'] else 'BROKEN'}")
    w()
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="telemetry.jsonl (or a run dir holding one); "
                         "two paths with --compare")
    ap.add_argument("--json", action="store_true",
                    help="print only the machine-readable JSON summary")
    ap.add_argument("--follow", action="store_true",
                    help="live-tail a run in progress (refreshing round "
                         "table + active alerts; exits at run_end)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--follow poll interval in seconds")
    ap.add_argument("--compare", action="store_true",
                    help="A/B span/metric delta table between two run "
                         "logs (pass exactly two paths)")
    ap.add_argument("--fleet", action="store_true",
                    help="render an orchestrator fleet JSONL "
                         "(fleet_events.jsonl or a fleet dir holding "
                         "one) as a per-tenant round table + aggregate "
                         "rounds/sec (scripts/orchestrate.py, "
                         "docs/packing.md)")
    args = ap.parse_args(argv)
    if args.fleet:
        if len(args.paths) != 1:
            print("--fleet expects exactly one fleet log", file=sys.stderr)
            return 2
        try:
            events = load_fleet_events(args.paths[0])
        except OSError as e:
            print(e, file=sys.stderr)
            return 2
        if not events:
            print("no events in fleet log", file=sys.stderr)
            return 2
        s = (summarize_fleet(events) if args.json
             else render_fleet(events))
        print(json.dumps(s, allow_nan=False))
        return 0
    if args.compare:
        if len(args.paths) != 2:
            print("--compare needs exactly two run logs", file=sys.stderr)
            return 2
        try:
            s = compare(args.paths[0], args.paths[1])
        except OSError as e:
            print(e, file=sys.stderr)
            return 2
        print(json.dumps(s, allow_nan=False))
        return 0
    if len(args.paths) != 1:
        print("exactly one run log expected (two only with --compare)",
              file=sys.stderr)
        return 2
    path = args.paths[0]
    if args.follow:
        return follow(path, interval=args.interval)
    try:
        events = load_events(path)
    except OSError as e:
        print(e, file=sys.stderr)
        return 2
    if not events:
        print("no events in log", file=sys.stderr)
        return 2
    if args.json:
        s = summarize(events)
    else:
        s = render(events)
    # machine-readable tail: ALWAYS the last stdout line
    print(json.dumps(s, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
