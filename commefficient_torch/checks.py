"""What the port's card tools (``chip_smoke.py``,
``scripts/card_measure.py``) hold their results to, and the process set-up
they share: equality of tensors bit for bit or with NaN positions matched,
the kernels' plain versions swapped in at their dispatch points, cuDNN held
deterministic, environment variables for a block, the card's memory
released, and a set of rank processes forked from one server that has
imported ``torch`` once.
"""

from __future__ import annotations

import contextlib
import gc
import multiprocessing as mp
import os
import time
from unittest import mock

import torch

from commefficient_torch import kernels
from commefficient_torch.ops import sketch as tsk
from commefficient_torch.ops import topk as ttk


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values (``==``: zero signs free), NaN positions matched."""
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, nan=0.0),
                                torch.nan_to_num(b, nan=0.0)))


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal NaN positions, and equal bit patterns (zero signs included)
    everywhere else."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan],
                                b.view(torch.int32)[~nan]))


def mask_past(est, t0, n_valid):
    """``mask_tail`` by global coordinate, written out: +0.0 at every
    position of the chunks from ``t0`` whose coordinate is >= n_valid."""
    coord = t0 * est.shape[1] * 128 + torch.arange(
        est.numel(), device=est.device).view(est.shape)
    return torch.where(coord < n_valid, est,
                       torch.zeros((), dtype=est.dtype, device=est.device))


def plain_estimates(table3, cs_, t0=0, Tn=None, n_valid=None):
    est = tsk._sketch_estimates_plain(table3, cs_.inv_q, cs_.inv_w,
                                      cs_.sign_keys, t0)
    return est if n_valid is None else mask_past(est, t0, n_valid)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel's dispatch point swapped for its plain version, on the
    card; no kernel may launch inside."""
    with contextlib.ExitStack() as stack:
        for mod, name, fn in (
                (tsk, "sketch_accumulate", tsk._sketch_accumulate_plain),
                (tsk, "sketch_accumulate_into",
                 tsk._sketch_accumulate_into_plain),
                (tsk, "sketch_segment_into", tsk._sketch_segment_into_plain),
                (tsk, "sketch_estimates", plain_estimates),
                (tsk, "fused_epilogue", tsk._fused_epilogue_plain),
                (ttk, "topk_count_ge", ttk._count_ge_plain),
                (ttk, "topk_descent", ttk._descent_plain)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        before = kernels.launch_counts()
        yield
        if kernels.launch_counts() != before:
            raise RuntimeError("a kernel launched inside plain_kernels()")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms (and no autotuning), so that
    two runs of one round give the same gradients bit for bit."""
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables set for the block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def release_card() -> dict:
    """Free what this process no longer uses on the card: collect
    unreachable objects (a model kept alive by a reference cycle holds its
    device memory until the collector runs), then return the allocator's
    cached blocks. Returns what stays held (nothing where this process
    has not used the card)."""
    if not torch.cuda.is_initialized():
        return {}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"allocated_GiB": torch.cuda.memory_allocated() / 2**30,
            "reserved_GiB": torch.cuda.memory_reserved() / 2**30}


# what the rank processes' server imports once, so that each rank starts
# from a fork of it instead of a fresh interpreter (``rank_context``)
RANK_PRELOAD = ["__main__", "numpy", "torch",
                "commefficient_torch.scripts.bench_rounds"]


def rank_context():
    """The ``multiprocessing`` context the ranks start in: ``forkserver``,
    whose server imports ``RANK_PRELOAD`` once (the calling script
    included; it never touches the card) and forks every rank from there,
    so a rank pays no interpreter start and no import of ``torch``. The
    first call starts the server; the caller goes on while it imports."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(RANK_PRELOAD)
    from multiprocessing import forkserver

    forkserver.ensure_running()
    return ctx


def _rank_main(env: dict, target, i: int, args) -> None:
    # the server's environment is the one it started with: a rank takes
    # the caller's as it stands at the spawn
    os.environ.clear()
    os.environ.update(env)
    target(i, *args)


def spawn_ranks(target, args, n: int = 4, timeout: float = 600.0,
                label: str = "ranks") -> None:
    """``n`` processes of ``target(i, *args)`` in ``rank_context()``, with
    this process's environment, all started, then joined within
    ``timeout`` seconds of the first start; raises unless all exit 0
    (those still alive at the timeout are killed). ``target`` must be
    importable by name from its module."""
    ctx = rank_context()
    env = dict(os.environ)
    procs = [ctx.Process(target=_rank_main, args=(env, target, i, args))
             for i in range(n)]
    t = time.perf_counter()
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join(max(1.0, timeout - (time.perf_counter() - t)))
    alive = [pr for pr in procs if pr.is_alive()]
    for pr in alive:
        pr.kill()
        pr.join()
    if alive or any(pr.exitcode != 0 for pr in procs):
        raise RuntimeError(f"{label}: exit codes "
                           f"{[pr.exitcode for pr in procs]} ({len(alive)} "
                           "killed at the timeout)")
