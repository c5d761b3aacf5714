"""Host-sync accounting, the liveness heartbeat, trace capture and
profiler annotations: the port's copy of ``commefficient_tpu/profiling.py``
(``materialize``, ``SyncCounter``, ``host_sync_monitor``, ``Heartbeat``,
``parse_trace_rounds``, ``RoundTracer``, ``StepProfiler``, ``annotate``)
on ``torch.profiler``.

``materialize`` is the one counted device-to-host fetch of the port: the
round's own fetches (``FedModel.finish_round`` / ``finish_rounds``, the
val call) go through it, so ``host_sync_monitor`` counts them on any
device, the CPU included. On the card, ``host_sync_monitor(strict=True)``
also arms ``torch.cuda.set_sync_debug_mode("error")``, so that any call
that waits on the stream in the monitored extent raises, counted seam or
not. A completion wait on a ``torch.cuda.Event`` (the round engine's
window) is not a stream synchronization and passes. ``offpath_fetches``
declares a thread's extent off the dispatch path (the row stores' I/O
worker), so the monitor does not count its fetches.

``RoundTracer`` (``--trace_rounds`` windows and the watch plane's trace
reaction, addressed by global round) and ``StepProfiler`` (``--profile``,
by loop index) each run a ``torch.profiler`` session that writes
``trace.json`` (Chrome trace format) into its directory. One session at a
time: a window that falls due while the other is capturing waits (the
tracer) or is skipped (the step profiler), as in the JAX package.
Starting a session may synchronize the card, so a strict audit keeps
trace windows outside its extent.

The card's timer, which ``chip_smoke.py`` and
``scripts/card_measure.py`` share: ``timing`` / ``time_ms`` (CUDA events
around one call, L2 flushed by ``flush_l2`` before it, the card spinning
for longer than the host takes to enqueue the call, which is marked
``host_bound`` where it did not), ``phase_split`` (the client and server
phases of a round), ``card_line`` (``nvidia-smi``'s name and power limit),
``peaks`` (the card's memory, float32 and int32 rates) and ``bound`` (the
least time a piece of work could take at those rates).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

__all__ = ["materialize", "SyncCounter", "host_sync_monitor", "Heartbeat",
           "HEARTBEAT_RE", "parse_heartbeat", "annotate", "parse_trace_rounds", "RoundTracer", "StepProfiler",
           "offpath_fetches", "flush_l2", "timing", "time_ms", "phase_split",
           "card_line", "peaks", "bound"]


class SyncCounter:
    """Tally of the ``materialize`` fetches made while a
    ``host_sync_monitor`` is active."""

    def __init__(self):
        self.count = 0

    def __int__(self):
        return self.count

    def __repr__(self):
        return f"SyncCounter(count={self.count})"


_lock = threading.Lock()
_active: list = []
# per thread: the depth of offpath_fetches extents
_offpath = threading.local()


def materialize(x) -> np.ndarray:
    """Blocking device-to-host fetch of ``x`` as a numpy array, counted by
    every active ``host_sync_monitor`` (a tensor on any device counts; a
    numpy array passes through uncounted), unless the calling thread is
    inside ``offpath_fetches``."""
    if isinstance(x, torch.Tensor):
        if not getattr(_offpath, "n", 0):
            with _lock:
                for c in _active:
                    c.count += 1
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def offpath_fetches():
    """Declare the dynamic extent, on the calling thread only, a fetch off
    the round's dispatch path: ``materialize`` there is not counted by any
    ``host_sync_monitor``. The row stores' ordered I/O worker
    (``federated/host_state.py``) runs its operations inside it: its
    fetches overlap the next round's compute by design, and the monitor
    stays an audit of the thread that dispatches rounds. The worker waits
    on CUDA events and reads pinned buffers rather than blocking copies,
    since ``host_sync_monitor(strict=True)``'s sync debug mode is
    process-wide."""
    _offpath.n = getattr(_offpath, "n", 0) + 1
    try:
        yield
    finally:
        _offpath.n -= 1


@contextlib.contextmanager
def host_sync_monitor(strict: bool = False):
    """Count ``materialize`` fetches in the dynamic extent; yields a
    ``SyncCounter``. With ``strict=True`` on a host with a card the extent
    also runs under ``torch.cuda.set_sync_debug_mode("error")``: a call
    that synchronizes the stream raises ``RuntimeError``. The previous
    mode is restored on exit."""
    counter = SyncCounter()
    arm = strict and torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if arm else None
    with _lock:
        _active.append(counter)
    try:
        if arm:
            torch.cuda.set_sync_debug_mode("error")
        yield counter
    finally:
        if arm:
            torch.cuda.set_sync_debug_mode(prev)
        with _lock:
            _active.remove(counter)


# the heartbeat line's one format: Heartbeat.round writes it and
# parse_heartbeat reads it (the supervisor and the crash matrix key on it);
# the optional fields follow the leading round=N
HEARTBEAT_RE = re.compile(
    r"HEARTBEAT round=(\d+)"
    r"(?: epoch=(\d+))?"
    r"(?: loss=(\S+))?"
    r"(?: guard=(ok|TRIP))?"
    r"(?: buf=(\d+))?"
    r"(?: stale=(\d+))?"
    r"(?: population=(\d+))?"
    r"(?: serve_lag=(\d+))?")


def parse_heartbeat(line: str):
    """One ``Heartbeat.round`` line -> ``{"round": int}`` plus the optional
    fields it carried (``epoch``, ``loss``, ``guard_ok``, ``buf``,
    ``stale``, ``population``, ``serve_lag``); None for any other line."""
    m = HEARTBEAT_RE.match(line.strip())
    if m is None:
        return None
    out = {"round": int(m.group(1))}
    if m.group(2) is not None:
        out["epoch"] = int(m.group(2))
    if m.group(3) is not None:
        try:
            out["loss"] = float(m.group(3))
        except ValueError:
            pass
    if m.group(4) is not None:
        out["guard_ok"] = m.group(4) == "ok"
    if m.group(5) is not None:
        out["buf"] = int(m.group(5))
    if m.group(6) is not None:
        out["stale"] = int(m.group(6))
    if m.group(7) is not None:
        out["population"] = int(m.group(7))
    if m.group(8) is not None:
        out["serve_lag"] = int(m.group(8))
    return out


class Heartbeat:
    """Per-round liveness lines for an external supervisor: armed by
    ``COMMEFFICIENT_HEARTBEAT=1`` (or ``enabled=True``), each drained
    round prints ``HEARTBEAT round=N [epoch=E] [loss=X] [guard=ok|TRIP]
    [buf=B] [stale=S] [population=P] [serve_lag=L]``
    to stderr, flushed: the JAX package's format; ``parse_heartbeat``
    here and the JAX package's read it. The round index is the model's global
    dispatch counter (``RoundHandle.round_no``). A no-op when disarmed
    (the default)."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("COMMEFFICIENT_HEARTBEAT") == "1"
        self.enabled = bool(enabled)

    def round(self, index: int, epoch: int | None = None,
              loss: float | None = None,
              guard_ok: bool | None = None,
              buffer: int | None = None,
              stale: int | None = None,
              population: int | None = None,
              serve_lag: int | None = None) -> None:
        """``buffer`` / ``stale`` (``--async_buffer``): the depth of the
        landed, unfolded buffer and the dispatch age of the oldest
        unfolded contribution, so a buffer that never folds shows on the
        line. ``population`` (``--churn``) is the live population;
        ``serve_lag`` (a serving replica's line) is the newest available
        minus the served model version."""
        if not self.enabled:
            return
        line = f"HEARTBEAT round={index}"
        if epoch is not None:
            line += f" epoch={epoch}"
        if loss is not None:
            line += f" loss={loss:.6g}"
        if guard_ok is not None:
            line += f" guard={'ok' if guard_ok else 'TRIP'}"
        if buffer is not None:
            line += f" buf={int(buffer)}"
        if stale is not None:
            line += f" stale={int(stale)}"
        if population is not None:
            line += f" population={int(population)}"
        if serve_lag is not None:
            line += f" serve_lag={int(serve_lag)}"
        print(line, file=sys.stderr, flush=True)


def parse_trace_rounds(spec: str) -> list:
    """``--trace_rounds`` spec -> sorted list of (start_round, count)
    windows over global round indices ('START:COUNT[,START:COUNT...]');
    a malformed spec raises here."""
    windows = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            start, count = (int(x) for x in part.split(":"))
        except ValueError:
            raise ValueError(
                f"--trace_rounds: bad entry {part!r}; expected "
                "START:COUNT (e.g. '10:3' or '10:3,200:5')") from None
        assert start >= 0, f"--trace_rounds: start {start} must be >= 0"
        assert count >= 1, f"--trace_rounds: count {count} must be >= 1"
        windows.append((start, count))
    return sorted(windows)


# one profiler session a process: StepProfiler and RoundTracer consult this
# and defer or skip instead of failing a run; the try/except around each
# start covers a session this flag cannot see
_session = None   # (torch.profiler.profile, logdir) while one is ours


def _try_start_trace(logdir: str) -> bool:
    global _session
    if _session is not None or torch.autograd._profiler_enabled():
        return False
    # the directory is made only once the session is ours
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 - a foreign active session
        print(f"trace capture skipped: profiler unavailable ({e})")
        return False
    _session = (prof, logdir)
    return True


def _stop_trace() -> None:
    """Stop our session and write ``<logdir>/trace.json``."""
    global _session
    if _session is None:
        return
    prof, logdir = _session
    _session = None
    prof.stop()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class RoundTracer:
    """Round-scoped trace capture addressed by global round index: static
    ``--trace_rounds START:COUNT`` windows and dynamic ``request(n)``
    windows (the watch plane's trace reaction).

    The engine calls ``on_submit(round_no)`` before a round's dispatch
    (it may start a session into ``<logdir>/trace_round_<start>``, named
    by the round it starts at) and ``on_drained(round_no)`` when a round
    drains (the session stops once the window's last round has drained,
    so its rounds are complete inside the capture; neighbours in flight
    appear too). A window due while another session is active waits for
    the next submit."""

    def __init__(self, logdir: str, windows=None):
        self.logdir = logdir
        self._pending = list(windows or [])   # static (start, count)
        self._requests = 0                    # dynamic: rounds still owed
        self._active = None                   # {start, until, dir}
        self.captures = []                    # completed capture records

    def request(self, count: int) -> bool:
        """Trace the next ``count`` submitted rounds; False when a
        capture is active or already requested (no nesting)."""
        if self._active is not None or self._requests:
            return False
        self._requests = int(count)
        return True

    def on_submit(self, round_no: int) -> None:
        """Before round ``round_no``'s dispatch; may start a capture."""
        if self._active is not None:
            return
        static = False
        if self._requests:
            count = self._requests
        elif self._pending and round_no >= self._pending[0][0]:
            # a static window whose start is due (or was passed, e.g. by
            # a resume): start now rather than never
            count, static = self._pending[0][1], True
        else:
            return
        trace_dir = os.path.join(self.logdir,
                                 f"trace_round_{round_no:06d}")
        if not _try_start_trace(trace_dir):
            return   # another session is active: retry at the next submit
        if static:
            self._pending.pop(0)
        else:
            self._requests = 0
        self._active = {"start": round_no,
                        "until": round_no + count - 1,
                        "dir": trace_dir}

    def on_drained(self, round_no: int):
        """After a round drained; stops the capture once its window's
        last round has drained and returns the capture record (for the
        ``trace_captured`` event), else None."""
        if self._active is None or round_no < self._active["until"]:
            return None
        return self._stop()

    def close(self):
        """Stop a capture left open at run end; its record or None."""
        if self._active is None:
            return None
        return self._stop()

    def _stop(self):
        rec, self._active = self._active, None
        _stop_trace()
        rec = {"round_start": rec["start"], "round_until": rec["until"],
               "dir": rec["dir"]}
        self.captures.append(rec)
        print(f"trace captured: rounds {rec['round_start']}-"
              f"{rec['round_until']} -> {rec['dir']}")
        return rec


class StepProfiler:
    """Trace loop indices ``[start_step, start_step + num_steps)``
    (``--profile``): ``step(i)`` at the top of each iteration starts and
    stops the session at the window's edges, ``close()`` stops one left
    open. A window due while a ``RoundTracer`` capture runs is skipped."""

    def __init__(self, logdir: str = "profiles", start_step: int = 2,
                 num_steps: int = 3, enabled: bool = False):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.enabled = enabled
        self._active = False

    def step(self, i: int):
        if not self.enabled:
            return
        if i == self.start_step and not self._active:
            if not _try_start_trace(self.logdir):
                return
            self._active = True
        elif i >= self.stop_step and self._active:
            _stop_trace()
            self._active = False
            print(f"profiler: trace written to {self.logdir}")

    def close(self):
        if self._active:
            _stop_trace()
            self._active = False


def annotate(name: str):
    """Context manager marking a host-side phase on the profiler
    timeline."""
    return torch.profiler.record_function(name)


@functools.lru_cache(maxsize=None)
def _flush_buffer(device_index: int) -> torch.Tensor:
    return torch.zeros(96 << 20, dtype=torch.uint8,
                       device=torch.device("cuda", device_index))


def flush_l2() -> None:
    """Read 96 MB, twice the H100's 50 MB L2, so the timed launch finds none
    of its data there. A read leaves clean lines, which the launch evicts
    for free; a write (``zero_``) would leave up to 50 MB of dirty lines
    whose write-back the launch would pay for."""
    _flush_buffer(torch.cuda.current_device()).max()


# the shortest spin before a timed launch, and the spin's length against
# the host's enqueue time of the timed call (``timing``)
LEAD_MS = 0.1
LEAD_OVER_HOST = 2.0


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms(device_index: int) -> float:
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card, from one
    spin of 2,000,000 cycles timed with CUDA events."""
    n = 2_000_000
    torch.cuda._sleep(n)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(n)
    e.record()
    e.synchronize()
    return n / s.elapsed_time(e)


def timing(fn, reps: int = 30, flush: bool = True) -> dict:
    """CUDA-event times of ``fn`` over ``reps`` calls, after 3 warm-up
    calls, with L2 flushed before each call (or not: then the call finds
    in L2 what the one before it left there).

    Before the start event the card spins (``torch.cuda._sleep``, which
    touches no memory) for the lead: ``LEAD_OVER_HOST`` times the host's
    time to enqueue one call between its events (the least of the warm-up
    calls after the first), and at least ``LEAD_MS``. The host has then
    enqueued the whole call by the time the card reaches it, so the
    events time the card's work alone. Returns ``{"ms": median device
    ms, "host_ms": median host ms to enqueue one timed call, "lead_ms":
    the spin, "host_bound": host_ms > lead_ms}``: where ``host_bound`` is
    true, the card may have waited for the host inside the timed call,
    and ``ms`` is not the card's time. A call that waits on the card
    itself (a device-to-host copy) is host-bound by nature, and its
    ``host_ms`` holds its device time."""
    def call(cycles: int):
        """One call between two events after a spin of ``cycles``: (the
        events, the host ms from the start event's record to the end
        event's)."""
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t = time.perf_counter()
        s.record()
        fn()
        e.record()
        return s, e, (time.perf_counter() - t) * 1e3

    warm = [call(0)[2] for _ in range(3)]
    torch.cuda.synchronize()
    lead_ms = max(LEAD_MS, LEAD_OVER_HOST * min(warm[1:]))
    cycles = int(lead_ms * _spin_cycles_per_ms(torch.cuda.current_device()))
    times, host = [], []
    for _ in range(reps):
        if flush:
            flush_l2()
        s, e, h = call(cycles)
        e.synchronize()
        times.append(s.elapsed_time(e))
        host.append(h)
    host_ms = statistics.median(host)
    return {"ms": statistics.median(times), "host_ms": host_ms,
            "lead_ms": lead_ms, "host_bound": host_ms > lead_ms}


def time_ms(fn, reps: int = 30, flush: bool = True) -> float:
    """The median CUDA-event ms of ``fn`` (``timing``)."""
    return timing(fn, reps, flush)["ms"]


def phase_split(fm, opt, sched, batch, label: str, n: int = 10) -> dict:
    """Median CUDA-event times of the client and server phases over ``n``
    rounds."""
    client_ms, server_ms = [], []
    for _ in range(n):
        sched.step()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        handle = fm.begin_round(batch)
        e[1].record()
        opt.step()
        e[2].record()
        fm.finish_round(handle)
        client_ms.append(e[0].elapsed_time(e[1]))
        server_ms.append(e[1].elapsed_time(e[2]))
    split = {"client_phase_ms": statistics.median(client_ms),
             "server_phase_ms": statistics.median(server_ms)}
    print(f"{label} phase split: " + json.dumps(split), flush=True)
    return split


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line (raises
    where ``nvidia-smi`` fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(bytes/s, float32 op/s, int32 op/s) of the card.

    Memory and float32 rates are NVIDIA's data-sheet numbers. The data
    sheets give no int32 rate; this one is the rate of the ALU pipe, which
    alone runs the right shifts and the logic ops (SHF, LOP3): the Hopper
    SM's 64 INT32 lanes (the Hopper architecture white paper: 64 INT32
    units per SM, against 128 FP32) times the SM count times the maximum SM
    clock that ``nvidia-smi`` reports: 64 x 132 x 1,980 MHz = 16.7 T int32
    op/s on an H100 SXM. Integer multiplies (IMAD), and the adds and left
    shifts that the compiler moves there, run on the FMA pipe beside it,
    and the SM issues 4 warp instructions a clock (128 lanes) over all its
    pipes, so an int32 count charged at this rate must be of ALU-pipe ops,
    or half the instructions of any kind."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32 = 64 * sms * mhz * 1e6
    if "PCIe" in name:
        return 2.0e12, 51e12, int32
    if "NVL" in name:
        return 3.9e12, 60e12, int32
    if "H200" in name:
        return 4.8e12, 67e12, int32
    return 3.35e12, 67e12, int32  # H100 SXM


def bound(nbytes: float, int_ops: float, flops: float, peak) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the card's rate for their
    type (int32 and float32 run on their own lanes, so the slower of the
    two)."""
    bw, frate, irate = peak
    tb, to = nbytes / bw, max(int_ops / irate, flops / frate)
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}
