"""Host-sync accounting, the liveness heartbeat and profiler annotations:
the port's own minimal copy of ``commefficient_tpu/profiling.py``
(``materialize``, ``SyncCounter``, ``host_sync_monitor``, ``Heartbeat``,
``annotate``). Telemetry, trace windows and watch rules are ROADMAP.md
queue 1 item 6.

``materialize`` is the one counted device-to-host fetch of the port: the
round's own fetches (``FedModel.finish_round`` / ``finish_rounds``, the
val call) go through it, so ``host_sync_monitor`` counts them on any
device, the CPU included. On the card, ``host_sync_monitor(strict=True)``
also arms ``torch.cuda.set_sync_debug_mode("error")``, so that any call
that waits on the stream in the monitored extent raises, counted seam or
not. A completion wait on a ``torch.cuda.Event`` (the round engine's
window) is not a stream synchronization and passes.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import numpy as np
import torch

__all__ = ["materialize", "SyncCounter", "host_sync_monitor", "Heartbeat",
           "annotate"]


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


def materialize(x) -> np.ndarray:
    """Blocking device-to-host fetch of ``x`` as a numpy array, counted by
    every active ``host_sync_monitor`` (a tensor on any device counts; a
    numpy array passes through uncounted)."""
    if isinstance(x, torch.Tensor):
        with _lock:
            for c in _active:
                c.count += 1
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    round prints ``HEARTBEAT round=N [loss=X]`` to stderr, flushed. The
    round index is the model's global dispatch counter
    (``RoundHandle.round_no``). A no-op when disarmed (the default)."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("COMMEFFICIENT_HEARTBEAT") == "1"
        self.enabled = bool(enabled)

    def round(self, index: int, loss: float | None = None) -> None:
        if not self.enabled:
            return
        line = f"HEARTBEAT round={index}"
        if loss is not None:
            line += f" loss={loss:.6g}"
        print(line, file=sys.stderr, flush=True)


def annotate(name: str):
    """Context manager marking a host-side phase on the profiler
    timeline."""
    return torch.profiler.record_function(name)
