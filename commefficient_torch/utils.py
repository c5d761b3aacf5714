"""Schedules, loggers, timing and run directories: the port's copy of
``commefficient_tpu/utils.py``'s public helpers (the schedules
``PiecewiseLinear``, ``Exp`` and ``Const``; ``Logger``, ``TableLogger``
and ``TSVLogger``; ``Timer``; ``make_logdir``) and the learning scripts'
harness ``run_cv_recorded``."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = ["PiecewiseLinear", "Exp", "Const", "Logger", "TableLogger",
           "TSVLogger", "Timer", "make_logdir", "run_cv_recorded"]


@dataclass(frozen=True)
class PiecewiseLinear:
    """Piecewise-linear schedule: ``np.interp`` over (knots, vals)."""

    knots: Sequence[float]
    vals: Sequence[float]

    def __call__(self, t):
        return np.interp([t], self.knots, self.vals)[0]


@dataclass(frozen=True)
class Exp:
    """Exponential decay ``initial * decay ** t``."""

    initial: float
    decay: float

    def __call__(self, t):
        return self.initial * (self.decay ** t)


@dataclass(frozen=True)
class Const:
    """The constant schedule."""

    val: float

    def __call__(self, t):
        return self.val


class Logger:
    """printf-style debug logger: ``debug`` / ``info`` print when
    ``verbose``."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose

    def debug(self, *args, **kwargs):
        if self.verbose:
            print(*args, **kwargs)

    info = debug


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


class TSVLogger:
    """Rows kept as ``epoch``, ``hours`` and ``top1Accuracy``, rendered as
    TSV by ``str``."""

    def __init__(self):
        self.log = [["epoch", "hours", "top1Accuracy"]]

    def append(self, row: dict):
        self.log.append([row.get("epoch", -1),
                         round(row.get("total_time", 0.0) / 3600, 6),
                         row.get("test_acc", 0.0)])

    def __str__(self):
        return "\n".join("\t".join(str(c) for c in r) for r in self.log)


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


def make_logdir(args) -> str:
    """Run-directory name from the federated config and a timestamp
    (``runs/<time>_w<workers>_c<clients>_<mode>[_r<rows>x<cols>k<k>]``);
    ``COMMEFFICIENT_RUN_DIR`` overrides it verbatim."""
    pinned = os.environ.get("COMMEFFICIENT_RUN_DIR", "")
    if pinned:
        return pinned
    parts = [
        time.strftime("%Y-%m-%d-%H%M%S"),
        f"w{getattr(args, 'num_workers', 0)}",
        f"c{getattr(args, 'num_clients', 0)}",
        str(getattr(args, "mode", "?")),
    ]
    if getattr(args, "mode", None) == "sketch":
        parts.append(f"r{getattr(args, 'num_rows', 0)}"
                     f"x{getattr(args, 'num_cols', 0)}k{getattr(args, 'k', 0)}")
    return os.path.join("runs", "_".join(parts))


def _plain(v):
    """A row's value as a JSON-ready Python scalar (numpy and 0-d torch
    scalars to ``int`` / ``float``)."""
    item = getattr(v, "item", None)
    return item() if callable(item) else v


def run_cv_recorded(argv, tag, echo=None):
    """Run ``cv_train.main(argv)`` with every ``TableLogger`` row captured.

    The harness of the learning-evidence scripts
    (``commefficient_torch/scripts/learning_*.py``,
    ``femnist_ablation.py``): returns the per-epoch rows the entry point
    would print (``epoch, lr, train_time, train_loss, train_acc,
    test_loss, test_acc, down (MiB), up (MiB), total_time``), echoing each
    one, flushed, with the run's ``tag``. The real ``TableLogger`` is
    restored on every exit path."""
    import functools

    from commefficient_torch import cv_train

    if echo is None:
        echo = functools.partial(print, flush=True)

    rows = []

    class _Recorder:
        def append(self, row):
            rows.append({k: _plain(v) for k, v in row.items()})
            echo(f"[{tag}] {rows[-1]}")

    orig = cv_train.TableLogger
    cv_train.TableLogger = _Recorder
    try:
        cv_train.main(argv)
    finally:
        cv_train.TableLogger = orig
    return rows
