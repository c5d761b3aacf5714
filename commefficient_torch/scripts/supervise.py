"""The port's supervisor: crash and hang watch, and relaunch with
``--resume auto``; a copy of the JAX package's ``scripts/supervise.py``
that imports nothing of it, so it runs on a machine without JAX.

It runs an entry point as a child (``python -m
commefficient_torch.cv_train ...`` or ``gpt2_train``), watches the round
engine's ``HEARTBEAT`` lines (``COMMEFFICIENT_HEARTBEAT=1``, read by
``commefficient_torch.profiling.parse_heartbeat``) for a crash (the child
exits) and a hang (no heartbeat within a deadline: SIGKILL, which a
SIGSTOP'd or wedged child cannot dodge), and relaunches with ``--resume
auto`` under exponential backoff and a bounded restart budget.

Poison-checkpoint exclusion: a run state can read and checksum clean yet
fail its resume every time. The supervisor notes which run state each
relaunch resumed from (the child's ``resumed run state from PATH``
line); one whose resume dies twice without a heartbeat is excluded
through ``COMMEFFICIENT_RESUME_EXCLUDE``, which
``checkpoint.find_resume_checkpoint`` honours, so the next relaunch
falls back to an older run state.

Every decision lands in a flushed JSONL event log (``--events``,
``{"ev": ..., "t": ...}`` lines) that ``python -m
commefficient_torch.scripts.obs_report`` renders as its Supervisor
section.

The ladder lives in the ``ChildRun`` state machine: ``supervise()``
blocks on one (events ``supervisor_*``), and
``commefficient_torch/scripts/orchestrate.py`` ticks one a tenant
(events ``tenant_*``).

Usage::

    python -m commefficient_torch.scripts.supervise [--heartbeat-timeout S]
        [--startup-grace S] [--max-restarts N] [--backoff S]
        [--backoff-max S] [--events PATH] [--procs N]
        -- python -m commefficient_torch.cv_train --args...

The child argv follows ``--``; a leading ``*.py`` or ``-m`` gets
``sys.executable`` in front. The first launch runs the argv as given;
relaunches append ``--resume auto`` unless it carries ``--resume``.

``--procs N`` supervises an N-process group as one unit: each launch
picks a fresh rendezvous port and starts N copies of the argv with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``). A process group cannot survive a lost
member, so a member's crash or nonzero exit, or silence of the whole
group, SIGKILLs every member and relaunches all N with ``--resume auto``.
A member that exits 0 waits for its peers.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

from commefficient_torch.profiling import parse_heartbeat

# the one resume-report line resume_run prints (federated/checkpoint.py)
RESUME_RE = re.compile(r"resumed run state from (\S+)")


def _free_port() -> int:
    """A currently-free localhost port for the cohort's rendezvous. The
    pick is inherently racy (the socket closes before the coordinator
    binds); the cohort restart ladder absorbs a lost race — a bind
    failure is just one failed launch, retried with a FRESH port."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def normalize_child(argv) -> list:
    """A leading ``*.py`` or ``-m`` gets ``sys.executable`` in front."""
    argv = list(argv)
    if argv and (argv[0].endswith(".py") or argv[0] == "-m"):
        argv = [sys.executable] + argv
    return argv


class EventLog:
    """Flushed JSONL event sink, telemetry-line-shaped so obs_report's
    reader consumes it unchanged."""

    def __init__(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")

    def event(self, ev: str, **fields) -> None:
        rec = {"ev": ev, "t": time.time()}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class _ChildWatch:
    """Shared liveness state the reader thread updates per child line."""

    def __init__(self, max_stale: int = 0):
        self.last_beat: float = 0.0   # monotonic stamp of the last beat
        self.beats: int = 0
        self.last_round: int = -1
        self.resumed_from: str = ""
        # async buffered federation (docs/async.md): a dispatch heartbeat
        # whose ``stale`` field (dispatch-age of the oldest un-folded
        # contribution) reaches this bound does NOT refresh liveness — a
        # full-but-never-folding buffer must not read as a healthy
        # heartbeat, so the ordinary hang deadline then declares the
        # child wedged. 0 disables the check (sync heartbeats carry no
        # ``stale`` field and are never affected).
        self.max_stale = int(max_stale)
        self.last_stale: int = 0


def _read_child(proc, watch: _ChildWatch, out) -> None:
    """Tee the child's merged stdout+stderr through ``out`` while parsing
    heartbeats (liveness) and the resume-report line (poison
    bookkeeping). Runs on a daemon thread; ends at child EOF."""
    try:
        for line in proc.stdout:
            try:
                out.write(line)
                out.flush()
            except (OSError, ValueError):
                pass
            hb = parse_heartbeat(line)
            if hb is not None:
                watch.beats += 1
                watch.last_round = hb["round"]
                watch.last_stale = hb.get("stale", 0)
                if not (watch.max_stale
                        and watch.last_stale >= watch.max_stale):
                    watch.last_beat = time.monotonic()
                continue
            m = RESUME_RE.search(line)
            if m:
                watch.resumed_from = m.group(1)
    except (OSError, ValueError):
        pass


class ChildRun:
    """The reusable child-run lifecycle: spawn → heartbeat liveness →
    crash/hang detection → relaunch with ``--resume auto`` under
    exponential backoff → poison-checkpoint exclusion → done/give-up.

    Poll-driven so a driver can hold many of them: ``tick()`` advances
    the state machine one step (spawn when due, poll the cohort, finish
    an attempt) and never sleeps — backoff is a *deadline* the next
    ``tick()`` honors, not a blocking wait. ``supervise()`` ticks one in
    a loop; ``scripts/orchestrate.py`` ticks one per tenant, which is
    exactly why a tenant's restart cannot stall its neighbors.

    Decisions surface through ``on_event(kind, **fields)`` with the
    generic kinds ``launch / cohort_kill / timeout / child_exit / poison
    / restart / giveup / done`` — each driver prefixes its own namespace
    (``supervisor_`` / ``tenant_``) without the field names drifting.
    """

    IDLE = "idle"          # not running: waiting out admission/backoff
    RUNNING = "running"
    PAUSED = "paused"      # SIGSTOP'd by the fair-share throttle
    DONE = "done"
    GAVE_UP = "gave_up"

    def __init__(self, argv, *, heartbeat_timeout: float = 120.0,
                 startup_grace: float = 900.0, max_restarts: int = 5,
                 backoff: float = 2.0, backoff_max: float = 60.0,
                 max_stale: int = 0, procs: int = 1, env_extra=None,
                 on_event=None, out=None, tag: str = "[child]"):
        self.argv = list(argv)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.startup_grace = float(startup_grace)
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        self.max_stale = int(max_stale)
        self.procs = max(1, int(procs))
        self.env_extra = dict(env_extra or {})
        self.on_event = on_event
        self.out = out if out is not None else sys.stdout
        self.tag = tag

        self.state = ChildRun.IDLE
        self.next_spawn = 0.0         # monotonic gate for (re)launch
        self.attempt = 0
        self.restarts = 0
        self.excluded: list = []
        self.final_rc: int = 0        # meaningful once DONE/GAVE_UP
        self.watch: _ChildWatch | None = None
        self._strikes: dict = {}
        self._consec_no_progress = 0
        self._beats_prev = 0          # beats from completed attempts
        self._last_round_prev = -1    # high-water round over attempts
        self._children: list = []
        self._readers: list = []
        self._pids: list = []
        self._t_launch = 0.0
        self._pause_started = 0.0

    # -- progress accounting (fair-share scheduling reads these) ---------

    @property
    def beats_total(self) -> int:
        """Heartbeats across ALL attempts (the fleet's progress unit)."""
        cur = self.watch.beats if self.watch is not None else 0
        return self._beats_prev + cur

    @property
    def last_round(self) -> int:
        cur = self.watch.last_round if self.watch is not None else -1
        return max(self._last_round_prev, cur)

    @property
    def terminal(self) -> bool:
        return self.state in (ChildRun.DONE, ChildRun.GAVE_UP)

    # -- internals -------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        if self.on_event is not None:
            self.on_event(kind, **fields)

    def _print(self, msg: str) -> None:
        try:
            print(f"{self.tag} {msg}", file=self.out, flush=True)
        except (OSError, ValueError):
            pass

    def _spawn(self) -> None:
        self.attempt += 1
        argv = list(self.argv)
        resume = self.attempt > 1 and "--resume" not in argv
        if resume:
            argv += ["--resume", "auto"]
        port = _free_port() if self.procs > 1 else None
        self._children = []
        for i in range(self.procs):
            env = dict(os.environ)
            env.update(self.env_extra)
            env["COMMEFFICIENT_HEARTBEAT"] = "1"
            # the child's stdout is a pipe: without this the resume-
            # report line sits in a block buffer until (possibly
            # after) the crash the supervisor needs it to diagnose
            env["PYTHONUNBUFFERED"] = "1"
            if self.excluded:
                env["COMMEFFICIENT_RESUME_EXCLUDE"] = \
                    os.pathsep.join(self.excluded)
            if self.procs > 1:
                # torchrun's environment, which the entry points' client
                # group reads (parallel/mesh.py)
                env["WORLD_SIZE"] = str(self.procs)
                env["RANK"] = env["LOCAL_RANK"] = str(i)
                env["MASTER_ADDR"] = "127.0.0.1"
                env["MASTER_PORT"] = str(port)
            self._children.append(subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        self._pids = [p.pid for p in self._children]
        self._print(f"launch attempt={self.attempt} pid(s)={self._pids}"
                    + (f" coordinator=127.0.0.1:{port}" if port else "")
                    + (" (--resume auto)" if resume else ""))
        self._event("launch", attempt=self.attempt, pid=self._pids[0],
                    pids=self._pids, resume=resume,
                    excluded=list(self.excluded))
        # ONE shared watch: any member's heartbeat counts as cohort
        # liveness (a wedged collective silences every member at once)
        self.watch = _ChildWatch(max_stale=self.max_stale)
        self._t_launch = time.monotonic()
        self._readers = []
        for p in self._children:
            r = threading.Thread(target=_read_child,
                                 args=(p, self.watch, self.out),
                                 daemon=True)
            r.start()
            self._readers.append(r)
        self.state = ChildRun.RUNNING

    def kill(self) -> None:
        """SIGKILL every live cohort member (lands on SIGSTOP'd ones
        too); used for hang recovery and driver shutdown."""
        for p in self._children:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in self._children:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                pass

    def pause(self) -> None:
        """SIGSTOP the cohort (fair-share throttle, docs/packing.md). A
        paused child cannot heartbeat, so the hang deadline is suspended
        until ``unpause()``."""
        if self.state != ChildRun.RUNNING:
            return
        import signal

        for p in self._children:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGSTOP)
                except OSError:
                    pass
        self._pause_started = time.monotonic()
        self.state = ChildRun.PAUSED

    def unpause(self) -> None:
        if self.state != ChildRun.PAUSED:
            return
        import signal

        for p in self._children:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGCONT)
                except OSError:
                    pass
        # the liveness clock must not count the stopped interval as
        # silence: credit the pause duration to the deadline bases
        paused_for = time.monotonic() - self._pause_started
        self._t_launch += paused_for
        if self.watch is not None and self.watch.last_beat:
            self.watch.last_beat += paused_for
        self.state = ChildRun.RUNNING

    def _finish_attempt(self, hang: bool) -> None:
        watch = self.watch
        rcs = [p.returncode for p in self._children]
        rc = (0 if all(r == 0 for r in rcs)
              else next((r for r in rcs if r not in (0, None)), 1))
        for r in self._readers:
            r.join(5)
        self._event("child_exit", attempt=self.attempt, rc=rc, hang=hang,
                    rounds_seen=watch.beats, last_round=watch.last_round,
                    resumed_from=watch.resumed_from or None)
        # fold the finished attempt into the cross-attempt totals and
        # drop the live watch so beats_total never double-counts it
        self._beats_prev += watch.beats
        self._last_round_prev = max(self._last_round_prev,
                                    watch.last_round)
        self.watch = None
        if rc == 0 and not hang:
            self.final_rc = 0
            self.state = ChildRun.DONE
            self._event("done", attempts=self.attempt,
                        restarts=self.restarts)
            self._print(f"child completed (attempt {self.attempt}, "
                        f"{self.restarts} restart(s))")
            return
        # poison-checkpoint bookkeeping: a resume that died before a
        # SINGLE heartbeat never got past restore/round 1 — two such
        # strikes exclude the candidate (find_resume_checkpoint's
        # exclude seam) so the next relaunch falls back to an older
        # checkpoint instead of crash-looping on this one
        if watch.resumed_from and watch.beats == 0:
            s = self._strikes.get(watch.resumed_from, 0) + 1
            self._strikes[watch.resumed_from] = s
            if s >= 2 and watch.resumed_from not in self.excluded:
                self.excluded.append(watch.resumed_from)
                self._event("poison", path=watch.resumed_from, strikes=s)
                self._print(f"poison checkpoint excluded after {s} "
                            f"failed resumes: {watch.resumed_from}")
        self.restarts += 1
        if self.restarts > self.max_restarts:
            self.final_rc = rc if isinstance(rc, int) and rc != 0 else 1
            self.state = ChildRun.GAVE_UP
            self._event("giveup", restarts=self.restarts - 1, rc=rc)
            self._print(f"restart budget exhausted ({self.max_restarts})"
                        f" — giving up (last rc {rc})")
            return
        # exponential backoff over CONSECUTIVE no-progress failures
        # (an attempt that heartbeat at all resets the exponent —
        # it was making progress before dying, relaunch promptly)
        self._consec_no_progress = (self._consec_no_progress + 1
                                    if watch.beats == 0 else 1)
        delay = min(self.backoff * (2 ** (self._consec_no_progress - 1)),
                    self.backoff_max)
        self._event("restart", attempt=self.attempt,
                    backoff_s=round(delay, 3),
                    reason="hang" if hang else "crash")
        self._print(f"restarting in {delay:g}s "
                    f"({'hang' if hang else f'crash rc={rc}'}; restart "
                    f"{self.restarts}/{self.max_restarts})")
        self.next_spawn = time.monotonic() + delay
        self.state = ChildRun.IDLE

    def tick(self) -> str:
        """Advance one step; returns the current state. Never blocks
        beyond a bounded cohort reap."""
        if self.terminal or self.state == ChildRun.PAUSED:
            return self.state
        if self.state == ChildRun.IDLE:
            if time.monotonic() >= self.next_spawn:
                self._spawn()
            return self.state
        # RUNNING: one poll pass of the old inner loop
        watch = self.watch
        rcs = [p.poll() for p in self._children]
        if any(r is not None and r != 0 for r in rcs):
            # a failed member takes the cohort down as a unit: a
            # process group cannot lose one rank and keep the
            # survivors out of a wedged collective
            if self.procs > 1 and any(r is None for r in rcs):
                self._event("cohort_kill", attempt=self.attempt, rcs=rcs)
                self._print(f"cohort member failed (rcs={rcs}) — "
                            f"SIGKILL the rest")
            self.kill()
            self._finish_attempt(hang=False)
            return self.state
        if all(r is not None for r in rcs):
            self._finish_attempt(hang=False)  # every member exited 0
            return self.state
        now = time.monotonic()
        if watch.beats:
            silent = now - watch.last_beat
            deadline = self.heartbeat_timeout
        else:
            # pre-first-heartbeat: the kernel build and init
            # legitimately take a while — a separate (longer) grace
            silent = now - self._t_launch
            deadline = max(self.heartbeat_timeout, self.startup_grace)
        if silent > deadline:
            self._event("timeout", attempt=self.attempt,
                        silent_s=round(silent, 1),
                        last_round=watch.last_round,
                        last_stale=watch.last_stale)
            stale_note = (
                f"; oldest un-folded contribution {watch.last_stale} "
                f"dispatches old (>= --max-stale {watch.max_stale}: "
                f"beats stopped counting as liveness)"
                if watch.max_stale
                and watch.last_stale >= watch.max_stale else "")
            self._print(f"no (live) heartbeat for {silent:.0f}s "
                        f"(deadline {deadline:g}s; last round "
                        f"{watch.last_round}{stale_note}) — SIGKILL "
                        f"pid(s) {self._pids}")
            self.kill()
            self._finish_attempt(hang=True)
        return self.state


def supervise(child_argv, heartbeat_timeout: float = 120.0,
              startup_grace: float = 900.0, max_restarts: int = 5,
              backoff: float = 2.0, backoff_max: float = 60.0,
              events_path: str = "supervise_events.jsonl",
              procs: int = 1, max_stale: int = 200, out=None) -> int:
    """Run ``child_argv`` to successful completion, restarting on crash
    or heartbeat-silence with ``--resume auto``; returns the final child
    return code (0 on recovered success). ``procs`` > 1 runs an
    N-process group restarted as a unit (module docstring).
    ``max_stale`` (async buffered federation): a
    heartbeat whose ``stale`` field — the dispatch-age of the oldest
    un-folded contribution — reaches this bound stops counting as
    liveness, so a child that keeps dispatching but never folds is
    declared hung by the ordinary deadline instead of reading healthy
    forever (0 disables). Thin blocking driver over ONE ``ChildRun``;
    the full ladder lives there."""
    out = out if out is not None else sys.stdout
    procs_n = max(1, int(procs))
    log = EventLog(events_path)
    log.event("supervisor_start", argv=list(child_argv),
              heartbeat_timeout=heartbeat_timeout,
              startup_grace=startup_grace, max_restarts=max_restarts,
              backoff=backoff, procs=procs_n, max_stale=max_stale)
    run = ChildRun(child_argv, heartbeat_timeout=heartbeat_timeout,
                   startup_grace=startup_grace, max_restarts=max_restarts,
                   backoff=backoff, backoff_max=backoff_max,
                   max_stale=max_stale, procs=procs_n, out=out,
                   tag="[supervise]",
                   on_event=lambda ev, **f: log.event("supervisor_" + ev,
                                                      **f))
    try:
        while True:
            st = run.tick()
            if st == ChildRun.DONE:
                return 0
            if st == ChildRun.GAVE_UP:
                return run.final_rc
            time.sleep(0.05 if st == ChildRun.IDLE else 0.25)
    finally:
        run.kill()
        log.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        usage="python -m commefficient_torch.scripts.supervise "
              "[options] -- PROG [ARGS...]")
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0,
                    help="seconds of heartbeat silence (after the first "
                         "beat) before the child is declared hung and "
                         "SIGKILLed")
    ap.add_argument("--startup-grace", type=float, default=900.0,
                    help="seconds allowed before the FIRST heartbeat "
                         "(kernel build + init)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="total relaunch budget before giving up")
    ap.add_argument("--backoff", type=float, default=2.0,
                    help="base restart delay; doubles per consecutive "
                         "no-progress failure")
    ap.add_argument("--backoff-max", type=float, default=60.0,
                    help="restart delay ceiling")
    ap.add_argument("--max-stale", type=int, default=200,
                    help="async buffered federation: a "
                         "heartbeat whose stale field (dispatch-age of "
                         "the oldest un-folded contribution) reaches "
                         "this bound stops refreshing liveness, so a "
                         "full-but-never-folding buffer is declared "
                         "hung by the ordinary deadline (0 disables)")
    ap.add_argument("--events", default="supervise_events.jsonl",
                    help="supervisor JSONL event log (python -m "
                         "commefficient_torch.scripts.obs_report "
                         "renders it)")
    ap.add_argument("--procs", type=int, default=1,
                    help="run the child as an N-process group "
                         "(torchrun's RANK/WORLD_SIZE/LOCAL_RANK/"
                         "MASTER_ADDR/MASTER_PORT environment) restarted "
                         "as a unit on any member failure")
    ap.add_argument("child", nargs=argparse.REMAINDER,
                    help="-- followed by the training command")
    args = ap.parse_args(argv)
    child = list(args.child)
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        ap.error("no child command given (append '-- PROG ARGS...')")
    child = normalize_child(child)
    return supervise(child, heartbeat_timeout=args.heartbeat_timeout,
                     startup_grace=args.startup_grace,
                     max_restarts=args.max_restarts, backoff=args.backoff,
                     backoff_max=args.backoff_max,
                     events_path=args.events, procs=args.procs,
                     max_stale=args.max_stale)


if __name__ == "__main__":
    sys.exit(main())
