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
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import numpy as np
import torch

__all__ = ["materialize", "SyncCounter", "host_sync_monitor", "Heartbeat",
           "annotate", "parse_trace_rounds", "RoundTracer", "StepProfiler",
           "offpath_fetches"]


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


class Heartbeat:
    """Per-round liveness lines for an external supervisor: armed by
    ``COMMEFFICIENT_HEARTBEAT=1`` (or ``enabled=True``), each drained
    round prints ``HEARTBEAT round=N [epoch=E] [loss=X] [guard=ok|TRIP]
    [buf=B] [stale=S]``
    to stderr, flushed: the JAX package's format, which its
    ``parse_heartbeat`` reads. The round index is the model's global
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
              stale: int | None = None) -> None:
        """``buffer`` / ``stale`` (``--async_buffer``): the depth of the
        landed, unfolded buffer and the dispatch age of the oldest
        unfolded contribution, so a buffer that never folds shows on the
        line."""
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
