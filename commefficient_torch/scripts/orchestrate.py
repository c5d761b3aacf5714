"""The port's fleet orchestrator: N tenant runs packed on one machine
and card; a copy of the JAX package's ``scripts/orchestrate.py`` that
imports nothing of it.

- **One ladder, N tenants.** Each tenant is a ``supervise.ChildRun``
  (``commefficient_torch/scripts/supervise.py``), ticked without
  blocking, so a dead tenant restarts with ``--resume auto`` while its
  neighbours run on; a backoff is a deadline, not a sleep.
- **Per-tenant namespace.** Tenant i gets ``<fleet>/t<i>/ckpt`` (its
  ``--checkpoint_path``) and ``t<i>/state`` (its ``--state_dir``),
  appended when its argv lacks them, and its run directory
  ``t<i>/run`` through ``COMMEFFICIENT_RUN_DIR`` (``utils.make_logdir``),
  so two tenants' telemetry logs and traces never collide.
- **Warm admission.** The first admitted tenant holds the machine alone
  until its first heartbeat: by then it has loaded the kernel library
  (built once into ``commefficient_torch/_build/`` by an atomic rename,
  ``kernels.py``) and warmed cuDNN, so later tenants start warm instead
  of racing the build. ``--no-warm-admission`` turns it off. The JAX
  package also shares an XLA compile cache between tenants; the port has
  none, sets no ``JAX_*`` variable, and its ``--keep-cache`` and
  ``--no-shared-cache`` parse as there (the second also turns warm
  admission off, as there) with nothing to share.
- **Fair share.** Admission is bounded (``--max-concurrent``) and least
  progress first (heartbeats, ties by tenant id: a deterministic order);
  ``--max-lead R`` SIGSTOPs a tenant R rounds ahead of the slowest live
  one until it catches up (its liveness clock suspended meanwhile).
- **Fleet JSONL.** Every decision is an event (``fleet_start``,
  ``tenant_admit``, ``tenant_start``, ``tenant_progress``,
  ``tenant_exit``, ``tenant_restart``, ``tenant_poison``,
  ``tenant_throttle``, ``tenant_unthrottle``, ``tenant_giveup``,
  ``tenant_finish``, ``fleet_done``), which ``python -m
  commefficient_torch.scripts.obs_report --fleet`` renders.
  Conservation: admitted == finished + gave_up at ``fleet_done``.

Usage::

    python -m commefficient_torch.scripts.orchestrate \\
        --fleet-dir runs/fleet_x --max-concurrent 2 \\
        --tenant "-m commefficient_torch.cv_train --seed 0 ..." \\
        --tenant "-m commefficient_torch.cv_train --seed 1 ..."

Each ``--tenant`` is one shlex-split child command (a leading ``*.py`` or
``-m`` gets ``sys.executable`` in front). The ladder's knobs
(``--heartbeat-timeout``, ``--startup-grace``, ``--max-restarts``,
``--backoff``, ``--backoff-max``, ``--max-stale``) apply per tenant.
"""

from __future__ import annotations

import argparse
import os
import shlex
import sys
import time

from commefficient_torch.scripts.supervise import (
    ChildRun,
    EventLog,
    normalize_child,
)


def orchestrate(tenants, *, fleet_dir: str, labels=None,
                max_concurrent: int = 0, warm_admission: bool = True,
                share_cache: bool = True, namespace_args: bool = True, max_lead: int = 0,
                progress_every: int = 1, heartbeat_timeout: float = 120.0,
                startup_grace: float = 900.0, max_restarts: int = 5,
                backoff: float = 2.0, backoff_max: float = 60.0,
                max_stale: int = 200, events_path: str = "",
                poll: float = 0.1, out=None) -> int:
    """Run every tenant argv to completion under the packed-fleet policy
    (module docstring); returns 0 iff every tenant finished, else 1.
    ``tenants`` is a list of argv lists; ``max_concurrent`` 0 means all
    at once (after the warm-admission gate). ``share_cache`` is the JAX
    package's argument: the port has no compile cache, so no directory is
    made and no variable set, and off it turns warm admission off, as
    there."""
    out = out if out is not None else sys.stdout
    n = len(tenants)
    if n == 0:
        raise ValueError("no tenants")
    mc = max_concurrent if max_concurrent and max_concurrent > 0 else n
    labels = list(labels) if labels else [f"t{i}" for i in range(n)]
    os.makedirs(fleet_dir, exist_ok=True)
    events_path = events_path or os.path.join(fleet_dir,
                                              "fleet_events.jsonl")
    log = EventLog(events_path)
    t0 = time.time()
    log.event("fleet_start", tenants=n, max_concurrent=mc,
              fleet_dir=fleet_dir, cache_dir=None,
              warm_admission=bool(warm_admission and share_cache),
              max_lead=max_lead, labels=labels)

    runs: list = [None] * n
    admitted_order: list = []
    last_emit = [-1] * n     # last round a tenant_progress was emitted for
    warm_open = not (warm_admission and share_cache)
    throttled = [False] * n

    def _mk_handler(i):
        _map = {"launch": "tenant_start", "done": "tenant_finish"}

        def handler(ev, **fields):
            name = _map.get(ev, "tenant_" + ev)
            if ev == "done" and runs[i] is not None:
                fields.setdefault("rounds", runs[i].beats_total)
            log.event(name, tenant=i, label=labels[i], **fields)
        return handler

    def _admit(i) -> None:
        tdir = os.path.join(fleet_dir, f"t{i}")
        run_dir = os.path.join(tdir, "run")
        os.makedirs(run_dir, exist_ok=True)
        argv = normalize_child(tenants[i])
        if namespace_args:
            # per-tenant checkpoint/state namespace: --resume auto after
            # a crash must find THIS tenant's checkpoints, never a
            # neighbor's (the isolation boundary, docs/packing.md)
            if "--checkpoint_path" not in argv:
                argv += ["--checkpoint_path", os.path.join(tdir, "ckpt")]
            if "--state_dir" not in argv:
                argv += ["--state_dir", os.path.join(tdir, "state")]
        env_extra = {
            "COMMEFFICIENT_RUN_DIR": run_dir,
            "COMMEFFICIENT_TENANT_ID": str(i),
        }
        log.event("tenant_admit", tenant=i, label=labels[i],
                  argv=argv, run_dir=run_dir)
        runs[i] = ChildRun(
            argv, heartbeat_timeout=heartbeat_timeout,
            startup_grace=startup_grace, max_restarts=max_restarts,
            backoff=backoff, backoff_max=backoff_max, max_stale=max_stale,
            env_extra=env_extra, out=out,
            tag=f"[orchestrate t{i}]", on_event=_mk_handler(i))
        admitted_order.append(i)

    try:
        while True:
            for i, r in enumerate(runs):
                if r is None or r.terminal:
                    continue
                r.tick()
                if r.last_round > last_emit[i] and \
                        r.last_round - last_emit[i] >= progress_every:
                    log.event("tenant_progress", tenant=i,
                              label=labels[i], round=r.last_round,
                              beats=r.beats_total)
                    last_emit[i] = r.last_round
            if max_lead > 0:
                _apply_throttle(runs, throttled, max_lead, log, labels)
            # admission AFTER the tick pass, so the heartbeat that
            # opened the warm gate is already in the log when the
            # follower admissions land (the JSONL reads causally)
            active = sum(1 for r in runs if r is not None
                         and not r.terminal)
            # warm-admission gate: open once any admitted tenant has
            # heartbeat (its kernel library built and loaded) or gone
            # terminal (don't wedge the fleet behind a tenant that can
            # never beat)
            if not warm_open:
                warm_open = any(
                    r is not None and (r.beats_total > 0 or r.terminal)
                    for r in runs)
                if warm_open and len(admitted_order) < n:
                    log.event("fleet_warm",
                              warmed_by=admitted_order[0]
                              if admitted_order else None)
            pending = [i for i in range(n) if runs[i] is None]
            slots = mc - active
            if pending and slots > 0:
                if not admitted_order:
                    _admit(pending[0])   # first tenant: the warmer
                elif warm_open:
                    # never-admitted tenants all sit at zero progress,
                    # so least-progress-first degenerates to tenant-id
                    # order — deterministic, and the max_lead throttle
                    # above is what keeps the share fair AFTER admission
                    for i in pending[:slots]:
                        _admit(i)
            if all(r is not None and r.terminal for r in runs):
                break
            time.sleep(poll)
    except BaseException:
        for r in runs:
            if r is not None and not r.terminal:
                r.kill()
        raise
    finally:
        wall = time.time() - t0
        finished = sum(1 for r in runs
                       if r is not None and r.state == ChildRun.DONE)
        gave_up = sum(1 for r in runs
                      if r is not None and r.state == ChildRun.GAVE_UP)
        total_rounds = sum(r.beats_total for r in runs if r is not None)
        restarts = sum(r.restarts for r in runs if r is not None)
        log.event("fleet_done", admitted=len(admitted_order),
                  finished=finished, gave_up=gave_up, restarts=restarts,
                  total_rounds=total_rounds, wall_s=round(wall, 3),
                  rounds_per_sec=round(total_rounds / wall, 4)
                  if wall > 0 else None)
        log.close()
    return 0 if all(r is not None and r.state == ChildRun.DONE
                    for r in runs) else 1


def _apply_throttle(runs, throttled, max_lead, log, labels) -> None:
    """SIGSTOP tenants more than ``max_lead`` rounds ahead of the
    slowest live tenant; SIGCONT them once the gap closes. The slowest
    tenant itself is never throttled (gap 0), so the fleet cannot
    deadlock."""
    live = [r for r in runs if r is not None and not r.terminal
            and r.beats_total > 0]
    if len(live) < 2:
        floor_round = None
    else:
        floor_round = min(r.last_round for r in live)
    for i, r in enumerate(runs):
        if r is None or r.terminal or r.beats_total == 0:
            continue
        lead = (r.last_round - floor_round
                if floor_round is not None else 0)
        if not throttled[i] and lead > max_lead \
                and r.state == ChildRun.RUNNING:
            r.pause()
            throttled[i] = True
            log.event("tenant_throttle", tenant=i, label=labels[i],
                      round=r.last_round, lead=lead)
        elif throttled[i] and lead <= max_lead:
            r.unpause()
            throttled[i] = False
            log.event("tenant_unthrottle", tenant=i, label=labels[i],
                      round=r.last_round, lead=lead)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        usage="python -m commefficient_torch.scripts.orchestrate "
              "[options] --tenant 'CMD...' [--tenant 'CMD...' ...]")
    ap.add_argument("--tenant", action="append", default=[],
                    help="one tenant child command (shlex-split; "
                         "repeatable)")
    ap.add_argument("--fleet-dir", default="",
                    help="fleet root (default runs/fleet_<timestamp>); "
                         "tenant t<i> gets <fleet>/t<i>/{ckpt,state,run}")
    ap.add_argument("--events", default="",
                    help="fleet JSONL path (default "
                         "<fleet-dir>/fleet_events.jsonl; python -m "
                         "commefficient_torch.scripts.obs_report "
                         "--fleet renders it)")
    ap.add_argument("--max-concurrent", type=int, default=0,
                    help="bounded tenant concurrency (0 = all tenants "
                         "at once, after the warm-admission gate)")
    ap.add_argument("--max-lead", type=int, default=0,
                    help="fair-share throttle: SIGSTOP a tenant this "
                         "many rounds ahead of the slowest live tenant "
                         "until it catches up (0 disables)")
    ap.add_argument("--progress-every", type=int, default=1,
                    help="emit tenant_progress every N rounds")
    ap.add_argument("--no-shared-cache", action="store_true",
                    help="the JAX package's flag: the port has no "
                         "compile cache to share; it turns warm "
                         "admission off, as there")
    ap.add_argument("--no-warm-admission", action="store_true",
                    help="admit all tenants immediately instead of "
                         "after the first tenant's first heartbeat")
    ap.add_argument("--keep-cache", action="store_true",
                    help="the JAX package's flag: the port has no "
                         "compile cache, so there is nothing to keep")
    ap.add_argument("--no-namespace-args", action="store_true",
                    help="don't append per-tenant --checkpoint_path/"
                         "--state_dir to tenant argvs")
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0)
    ap.add_argument("--startup-grace", type=float, default=900.0)
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--backoff", type=float, default=2.0)
    ap.add_argument("--backoff-max", type=float, default=60.0)
    ap.add_argument("--max-stale", type=int, default=200)
    args = ap.parse_args(argv)
    if not args.tenant:
        ap.error("no tenants given (repeat --tenant 'CMD ...')")
    tenants = [shlex.split(t) for t in args.tenant]
    fleet_dir = args.fleet_dir or os.path.join(
        "runs", f"fleet_{time.strftime('%Y%m%d_%H%M%S')}")
    labels = [os.path.basename(t[0]) if t else f"t{i}"
              for i, t in enumerate(tenants)]
    rc = orchestrate(
        tenants, fleet_dir=fleet_dir, labels=labels,
        max_concurrent=args.max_concurrent,
        warm_admission=not args.no_warm_admission,
        share_cache=not args.no_shared_cache,
        namespace_args=not args.no_namespace_args,
        max_lead=args.max_lead, progress_every=args.progress_every,
        heartbeat_timeout=args.heartbeat_timeout,
        startup_grace=args.startup_grace,
        max_restarts=args.max_restarts, backoff=args.backoff,
        backoff_max=args.backoff_max, max_stale=args.max_stale,
        events_path=args.events)
    events = args.events or os.path.join(fleet_dir, "fleet_events.jsonl")
    print(f"[orchestrate] fleet {'complete' if rc == 0 else 'DEGRADED'} "
          f"(rc {rc}); render with: python -m "
          f"commefficient_torch.scripts.obs_report --fleet {events}",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
