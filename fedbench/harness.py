"""One run of a cell: set-up, the checked first rounds, the timed window
(or the traced part), and the comparison with the reference.

Set-up builds the port's ``FedModel``, ``FedOptimizer`` and ``LambdaLR``
from the configuration's recipe and the mix's cohort, with the benchmark's
initial weights (drawn on the device from the seed), attaches the run
telemetry as the entry points do (telemetry, histograms and watch on, the
event log under ``TMPDIR``), and drives ``PipelinedRoundEngine.submit``
with the entry points' defaults (``--round_window`` 2,
``--metrics_drain_every`` 8) on a pool of rounds drawn from the seed. The
first three submits are the checked rounds; more rounds through two
drains warm every shape up; the window starts on an empty pipeline.

The window submits rounds until ``seconds`` have passed, then drains and
syncs. After each submit returns, a CUDA event is recorded on the rounds'
stream; the intervals between consecutive events are the rounds'
completion intervals. ``rounds_per_s`` is the rounds over the window's
host-clock seconds. The traced run (``--trace 1``) runs the same window
for its round rate, then captures ``2 * drain_every + 1`` rounds under the
profiler (``fedbench/trace.py``) for the per-layer readers.
"""

from __future__ import annotations

import gc
import math
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from fedbench import check, spec, trace, traffic
from fedbench.reference import precision
from fedbench.reference.fetchsgd import Round, run as reference_run
from fedbench.reference.flat import Layout, initial_weights

CHECKED_ROUNDS = 3


class Seeds(NamedTuple):
    program: int   # the program's --seed: sketch hash, round generator
    data: int      # the pool of rounds
    weights: int   # the initial weights


def seeds(seed: int) -> Seeds:
    """Three independent seeds from ``--seed`` (any whole number)."""
    a, b, c = np.random.SeedSequence(int(seed) % 2**64).generate_state(3)
    return Seeds(int(a) % (2**31 - 2), int(b), int(c))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def program_argv(c: spec.Cell, s: Seeds, device: str) -> List[str]:
    """The program's flags: the recipe, the mix's cohort and flags."""
    mix = c.traffic
    argv = []
    for k, v in {**c.recipe, **mix.get("flags", {})}.items():
        argv += [f"--{k}", str(v)]
    return argv + ["--num_workers", str(mix["clients_per_round"]),
                   "--local_batch_size", str(mix["examples_per_client"]),
                   "--num_clients", str(mix["population"]),
                   "--seed", str(s.program), "--device", device]


class Program:
    """The system under test: the port's round objects and its engine."""

    def __init__(self, c: spec.Cell, s: Seeds, device: str, log_dir: str):
        from commefficient_torch.config import parse_args
        from commefficient_torch.federated import (
            FedModel,
            FedOptimizer,
            LambdaLR,
        )
        from commefficient_torch.federated.engine import PipelinedRoundEngine
        from commefficient_torch.telemetry import attach_run_telemetry

        ref = spec.reference(c)
        self.layout = Layout(ref.leaves(c.config))
        model, train_loss, val_loss = spec.program(c).build(c.config)
        self.args = parse_args(argv=program_argv(c, s, device))
        w0 = initial_weights(self.layout, ref.init_rule, c.config,
                             s.weights, device)
        self.fm = FedModel(model, train_loss, self.args, val_loss,
                           num_clients=int(c.traffic["population"]),
                           init_params=w0, device=device)
        del w0
        if self.fm.grad_size != self.layout.d:
            raise ValueError(f"the program's d {self.fm.grad_size} is not "
                             f"the reference's {self.layout.d}")
        self.opt = FedOptimizer(self.fm, self.args)
        lr = float(c.config["lr"])
        self.sched = LambdaLR(self.opt, lambda step: lr)
        self.telemetry = attach_run_telemetry(self.args, self.fm, log_dir,
                                              c.name)
        self.engine = PipelinedRoundEngine(
            self.fm, self.opt, self.sched, window=self.args.round_window,
            drain_every=self.args.metrics_drain_every)

    def weights(self) -> torch.Tensor:
        """The flat weights on the host (the resident layout holds the
        flat vector, zero-padded in sketch mode)."""
        return self.fm.ps_weights.detach().reshape(-1)[:self.layout.d].cpu()

    def close(self) -> None:
        from commefficient_torch.telemetry import close_run_telemetry

        self.engine.drain()
        close_run_telemetry(self.fm, self.telemetry)
        self.fm.finalize()


def first_rounds(p: Program, pool) -> dict:
    """The checked rounds through ``engine.submit``: each round's
    per-client losses (from the drain), the server's velocity after the
    first round, and the weights after the last."""
    p.engine.submit(pool[0])
    velocity = p.opt.server_state.velocity.detach().cpu()
    for i in range(1, CHECKED_ROUNDS):
        p.engine.submit(pool[i])
    weights = p.weights()
    drained = p.engine.drain()
    losses = np.stack([np.asarray(r.values[0], np.float64)
                       for r in drained])
    return {"losses": losses, "velocity": velocity, "weights": weights}


class Window(NamedTuple):
    rounds: int
    seconds: float
    intervals_ms: List[float]
    failed: int
    fetches: int
    drains: int
    launches: Dict[str, int]
    started: float   # time.time() at the first timed submit
    last_loss: float  # the mean client loss of the last round


def timed_window(p: Program, pool, seconds: float, start: int) -> Window:
    """Submit rounds from an empty pipeline until ``seconds`` have passed,
    then drain and sync. On the card each submit is followed by a CUDA
    event on the rounds' stream; on the CPU by a host-clock stamp."""
    from commefficient_torch import kernels
    from commefficient_torch.profiling import host_sync_monitor

    cuda = p.fm.device.type == "cuda"
    p.engine.drain()
    if cuda:
        torch.cuda.synchronize()

    def stamp():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    drained, drains0 = [], p.engine.drains
    kernels.reset_launch_counts()
    with host_sync_monitor() as fetches:
        marks = [stamp()]
        started = time.time()
        t0 = time.perf_counter()
        n = 0
        while True:
            drained += p.engine.submit(pool[(start + n) % len(pool)])
            n += 1
            marks.append(stamp())
            if time.perf_counter() - t0 >= seconds:
                break
        drained += p.engine.drain()
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if cuda:
        intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        intervals = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    failed = sum(1 for r in drained
                 if not np.all(np.isfinite(np.asarray(r.values[0]))))
    return Window(n, dt, intervals, failed, fetches.count,
                  p.engine.drains - drains0, kernels.launch_counts(),
                  started, float(np.mean(drained[-1].values[0])))


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


def reference_rounds(c: spec.Cell, s: Seeds, pool, device: str,
                     tf32: bool = False, drop_clients: int = 0) -> dict:
    """The reference over the checked rounds, from the same initial
    weights and batches (and the program's seed for the sketch's hash and
    the dropout masks); also ``w0``, the initial weights on the host."""
    ref = spec.reference(c)
    layout = Layout(ref.leaves(c.config))
    w0 = initial_weights(layout, ref.init_rule, c.config, s.weights, device)
    rnd = Round(ref, c.config, c.recipe, layout, s.program, device,
                dropout_seed=s.program + 1)
    dev = torch.device(device)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in pool[:CHECKED_ROUNDS]]
    with precision(tf32):
        out = reference_run(rnd, w0, batches, float(c.config["lr"]),
                            drop_clients)
    out["w0"] = w0.cpu()
    out["layout"] = layout
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    return check.numbers(prog, ref, ref["layout"], ref["w0"])


def card_line() -> str:
    """The card's name, power limit and SM clocks (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


class Context(NamedTuple):
    """What a per-layer reader gets: the capture, the cell, the plain
    part's round rate and the card's name."""

    capture: trace.Capture
    cell: spec.Cell
    rounds_per_s: float
    card: str

    def d(self) -> int:
        """The model's parameter count (the reference's layout)."""
        return Layout(spec.reference(self.cell).leaves(self.cell.config)).d

    def round_flops(self) -> float:
        """The model FLOPs of one round's forward and backward over the
        cohort (``reference/<model>.py``'s ``train_flops``)."""
        ref = spec.reference(self.cell)
        mix = self.cell.traffic
        shape = mix["fields"][ref.MAIN_FIELD]["shape"]
        return (int(mix["clients_per_round"]) * int(shape[0])
                * ref.train_flops(self.cell.config, shape))


def _finite(x) -> Optional[float]:
    return float(x) if x is not None and math.isfinite(float(x)) else None


def run(c: spec.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_process: Optional[float] = None) -> dict:
    """One run of cell ``c``; returns the result line's fields.
    ``t_process``: the process's start (``time.time()`` scale), from
    which ``setup_s`` is taken."""
    t_process = time.time() if t_process is None else t_process

    def stage(name):
        log(f"set-up: {name} at {time.time() - t_process:.3f} s")

    stage("imports")
    s = seeds(seed)
    cuda = torch.device(device).type == "cuda"
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    if cuda:
        log(f"card: {card_line()}")
    stage("the card")
    pool = traffic.rounds(c.traffic, s.data)
    stage("the pool of rounds")
    log_dir = tempfile.mkdtemp(prefix="fedbench-")
    try:
        p = Program(c, s, device, log_dir)
        stage("the program built")
        prog = first_rounds(p, pool)
        stage("the checked rounds (the kernels built on a first run)")
        warm = 2 * p.engine.drain_every
        for i in range(warm):
            p.engine.submit(pool[(CHECKED_ROUNDS + i) % len(pool)])
        stage("the warm-up rounds")
        start = CHECKED_ROUNDS + warm
        win = timed_window(p, pool, seconds, start)
        setup_s = win.started - t_process
        rate = win.rounds / win.seconds
        log(f"window: {win.rounds} rounds in {win.seconds:.3f} s, "
            f"{win.drains} drains, {win.fetches} fetches, {win.failed} "
            f"non-finite; launches a round: "
            + ", ".join(f"{k} {v / win.rounds:.2f}"
                        for k, v in win.launches.items()))
        metrics, traced_dev, bd = {}, {}, None
        if traced:
            start += win.rounds
            p.engine.drain()
            n = 2 * p.engine.drain_every + 1
            k = iter(range(start, start + n))
            cap = trace.capture(
                lambda: p.engine.submit(pool[next(k) % len(pool)]), n)
            ctx = Context(cap, c, rate, card)
            for m in c.per_layer:
                v = _finite(spec.reader(c, m["name"]).read(ctx))
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            traced_dev = {
                "busy_s": sum(b - a for a, b in cap.busy()) / 1e6,
                "window_s": (cap.window[1] - cap.window[0]) / 1e6}
            bd = trace.breakdown(cap)
        else:
            e2e = {"rounds_per_s": rate,
                   "round_ms_p95": p95(win.intervals_ms),
                   "setup_s": setup_s}
            for m in c.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log(f"memory peak {peak} bytes; setup {setup_s:.3f} s; "
            f"round ms p50 {float(np.median(win.intervals_ms)):.3f}, "
            f"p95 {p95(win.intervals_ms):.3f}, "
            f"max {max(win.intervals_ms):.3f}")
        p.close()
        del p
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_rounds(c, s, pool, device)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s; losses of the "
        f"checked rounds {np.round(ref['losses'].mean(1), 5).tolist()}, "
        f"last drained {win.last_loss:.5f}")
    ok, checks = check.verdict(compare(prog, ref), c.limits)
    for name, v in checks.items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": c.chips, "memory_peak_bytes": int(peak), **traced_dev}
    out = {"correct": ok, "attempted": win.rounds, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if bd is not None:
        out["breakdown"] = bd
    out["checks"] = checks
    return out
