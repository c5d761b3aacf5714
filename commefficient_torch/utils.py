"""Schedules, loggers and timing: the port's copy of the parts of
``commefficient_tpu/utils.py`` the CV entry point uses."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = ["PiecewiseLinear", "TableLogger", "Timer"]


@dataclass(frozen=True)
class PiecewiseLinear:
    """Piecewise-linear schedule: ``np.interp`` over (knots, vals)."""

    knots: Sequence[float]
    vals: Sequence[float]

    def __call__(self, t):
        return np.interp([t], self.knots, self.vals)[0]


class TableLogger:
    """Fixed-width console table: header printed on the first append."""

    def __init__(self):
        self.keys = None

    def append(self, row: dict):
        if self.keys is None:
            self.keys = list(row.keys())
            print(*(f"{k:>12s}" for k in self.keys))
        cells = []
        for k in self.keys:
            v = row.get(k, "")
            if isinstance(v, (float, np.floating)):
                cells.append(f"{v:12.4f}")
            else:
                cells.append(f"{str(v):>12s}")
        print(*cells)


class Timer:
    """Cumulative timer: ``timer()`` returns seconds since the last call
    and (optionally) adds them to the running total. ``synch`` runs first
    (e.g. ``torch.cuda.synchronize``), so device work is counted."""

    def __init__(self, synch=None):
        self.synch = synch or (lambda: None)
        self.t = time.perf_counter()
        self.total_time = 0.0

    def __call__(self, include_in_total: bool = True) -> float:
        self.synch()
        now = time.perf_counter()
        dt = now - self.t
        self.t = now
        if include_in_total:
            self.total_time += dt
        return dt
