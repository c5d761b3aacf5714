#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels from ``commefficient_torch/csrc`` and print ptxas's
   register / shared-memory / spill summary;
3. each kernel against its plain version at the headline geometry
   (d = 6,568,640, 5 x 500,000 sketch) and at a ragged one (c not a
   multiple of 128, a partial last chunk, even r, t0 != 0, NaN, inf and
   subnormal cells): exact equality, then CUDA-event times (median of 30,
   L2 flushed before each launch) beside the bound the card's memory rate
   sets;
4. the headline FetchSGD round at full width through FedModel /
   FedOptimizer / LambdaLR on a seeded synthetic batch (8 clients x 8
   images): 2 warm-up and 20 timed rounds, rounds/sec, a finite loss,
   and exactly 2 / 1 / 8 launches per round of the three kernels; then the
   server phase from one table and state through the kernels and through
   the plain versions, which must be equal;
5. ``commefficient_torch.cv_train.main`` for one short epoch and an eval
   on synthetic CIFAR10 in a temporary directory.

Then one JSON line of the kernels (main-path launches from phase 4), the
card's line, and ``{"ok": true, "device": {...}}`` as the last line.
Without a card it exits with an error before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from commefficient_torch import kernels
from commefficient_torch.config import parse_args
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR
from commefficient_torch.federated.losses import make_cv_losses
from commefficient_torch.federated.server import server_update
from commefficient_torch.models import ResNet9
from commefficient_torch.ops import sketch as tsk
from commefficient_torch.ops import topk as ttk
from commefficient_torch.utils import PiecewiseLinear

HEADLINE = ["--mode", "sketch", "--error_type", "virtual",
            "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
            "--num_workers", "8", "--local_batch_size", "8",
            "--dataset_name", "CIFAR10", "--device", "cuda"]
TIMED_ROUNDS = 20
REPS = 30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(bytes/s, float32 op/s) of the card, from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    if "H200" in name:
        return 4.8e12, 67e12
    return 3.35e12, 67e12  # H100 SXM


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, nan=0.0),
                                torch.nan_to_num(b, nan=0.0)))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fa = a.to(torch.float64)
    fb = b.to(torch.float64)
    both = torch.isfinite(fa) & torch.isfinite(fb)
    if not both.any():
        return 0.0
    return float((fa[both] - fb[both]).abs().max())


_FLUSH = {}


def flush_l2():
    buf = _FLUSH.get("buf")
    if buf is None:
        buf = _FLUSH["buf"] = torch.empty(96 << 20, dtype=torch.uint8,
                                          device="cuda")
    buf.zero_()


def time_ms(fn) -> float:
    """Median CUDA-event time of ``fn`` over REPS launches, L2 flushed
    before each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush_l2()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def special(x: torch.Tensor) -> torch.Tensor:
    flat = x.view(-1)
    flat[3] = float("nan")
    flat[5] = float("inf")
    flat[8] = float("-inf")
    flat[11:40] = 1e-40
    flat[41] = -0.0
    return x


def bound(nbytes: float, ops: float, bw: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    tb, to = nbytes / bw, ops / flops
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def check_kernels(card: str, d, c, r, t0, seed, label, timed):
    """Phase 3 for one geometry: every kernel against its plain version."""
    bw, flops = peaks(card)
    dev = torch.device("cuda")
    cs = tsk.make_sketch(d, c, r, seed=seed, device=dev)
    Tn = cs.T - t0
    c_pad, S = cs.c_pad, cs.sublanes
    gen = torch.Generator().manual_seed(seed)
    v3 = torch.randn((Tn, S, 128), generator=gen)
    if t0 == 0:
        v3 = cs.chunk_layout.chunk(cs.chunk_layout.unchunk(v3))  # zero tail
    if not timed:
        v3 = special(v3)
    v3 = v3.to(dev)
    q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
    iq, iw = tsk._shift_cols(cs.inv_q, cs.inv_w, t0, Tn)
    keys = cs.sign_keys
    results = {}

    # accumulate
    got = kernels.sketch_accumulate(v3, q, w, keys, t0)
    want = tsk._sketch_accumulate_plain(v3, q, w, keys, t0)
    torch.cuda.synchronize()
    assert nan_equal(got, want), f"{label}: sketch_accumulate != plain"
    acc_bytes = 4 * (v3.numel() + got.numel() + 2 * q.numel() + r)
    results["sketch_accumulate"] = dict(
        max_abs_err=max_abs_err(got, want),
        **bound(acc_bytes, 2 * r * Tn * c_pad, bw, flops))
    if timed:
        results["sketch_accumulate"]["ms"] = time_ms(
            lambda: kernels.sketch_accumulate(v3, q, w, keys, t0))
        results["sketch_accumulate"]["plain_ms"] = time_ms(
            lambda: tsk._sketch_accumulate_plain(v3, q, w, keys, t0))

    # query
    table3 = want if timed else special(want.clone())
    got = kernels.sketch_estimates(table3, q, w, keys, t0)
    want = tsk._sketch_estimates_plain(table3, iq, iw, keys, t0)
    torch.cuda.synchronize()
    assert nan_equal(got, want), f"{label}: sketch_estimates != plain"
    est_bytes = 4 * (table3.numel() + got.numel() + 2 * q.numel() + r)
    est_ops = Tn * c_pad * (r + r * (r - 1) + 1)
    results["sketch_estimates"] = dict(
        max_abs_err=max_abs_err(got, want),
        **bound(est_bytes, est_ops, bw, flops))
    if timed:
        results["sketch_estimates"]["ms"] = time_ms(
            lambda: kernels.sketch_estimates(table3, q, w, keys, t0))
        results["sketch_estimates"]["plain_ms"] = time_ms(
            lambda: tsk._sketch_estimates_plain(table3, iq, iw, keys, t0))

    # count passes: the whole descent over the estimate plane, each pass
    # against the plain count
    est = cs.chunk_layout.mask_tail(want) if t0 == 0 else want
    bits = est.reshape(-1).view(torch.int32)
    k = max(1, bits.numel() // 140)
    p = torch.zeros((), dtype=torch.int32, device=dev)
    for shift in range(28, -1, -4):
        ts = ttk._pass_thresholds(p, shift)
        got_c = kernels.topk_count_ge(bits, ts)
        want_c = ttk._count_ge_plain(bits, ts)
        assert torch.equal(got_c, want_c), f"{label}: topk_count_ge != plain"
        p = p + ((want_c >= k).sum().to(torch.int32) << shift)
    assert int(ttk.resolve_threshold(est, k)) == int(p)
    n = bits.numel()
    results["topk_count_ge"] = dict(
        max_abs_err=0.0,
        **bound(4 * (n + 32), 2 * 16 * n, bw, flops))
    if timed:
        ts0 = ttk._pass_thresholds(torch.zeros((), dtype=torch.int32,
                                               device=dev), 28)
        results["topk_count_ge"]["ms"] = time_ms(
            lambda: kernels.topk_count_ge(bits, ts0))
        results["topk_count_ge"]["plain_ms"] = time_ms(
            lambda: ttk._count_ge_plain(bits, ts0))
    return results


def synthetic_batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(8, 8, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(8, 8)).astype(np.int64),
            "mask": np.ones((8, 8), np.float32),
            "client_ids": np.arange(8, dtype=np.int32),
            "worker_mask": np.ones(8, np.float32)}


def phase_rounds():
    """Phase 4: the headline round at full width."""
    args = parse_args(argv=HEADLINE + ["--num_clients", "64", "--seed", "0"])
    model = ResNet9()
    train_loss, val_loss = make_cv_losses(model)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=64)
    opt = FedOptimizer(fm, args)
    spe = 50
    schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                               [0, 0.4, 0])
    sched = LambdaLR(opt, lambda step: schedule(step / spe))
    print(f"model d = {fm.grad_size:,}, sketch {fm.sketch.r} x "
          f"{fm.sketch.c_pad} (T = {fm.sketch.T}), k = {args.k}")
    batch = synthetic_batch()

    def one_round():
        sched.step()
        out = fm(batch)
        opt.step()
        return out

    for _ in range(2):
        one_round()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TIMED_ROUNDS):
        losses.append(one_round()[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    loss = np.concatenate(losses)
    assert np.all(np.isfinite(loss)), "non-finite round loss"
    want = {"sketch_accumulate": 2 * TIMED_ROUNDS,
            "sketch_estimates": TIMED_ROUNDS,
            "topk_count_ge": 8 * TIMED_ROUNDS}
    assert counts == want, f"launches {counts}, expected {want}"
    rps = TIMED_ROUNDS / wall
    print(f"rounds: {TIMED_ROUNDS} timed, {rps:.3f} rounds/sec "
          f"({1e3 / rps:.2f} ms/round), mean loss {loss.mean():.4f}")

    # per-phase split: CUDA events around the client and server phases
    client_ms, server_ms = [], []
    for _ in range(10):
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
    print("phase split: " + json.dumps(split))
    split.update(profile_rounds(one_round))

    # the server phase exact: one table and state through the kernels and
    # through the plain versions, all on the card
    cs = fm.sketch
    fm.begin_round(synthetic_batch(1))
    table = fm._round_table
    state = opt.server_state
    lr = opt.get_lr()
    upd_k, st_k = server_update(table, state, fm.server_config, lr,
                                sketch=cs, layout=fm.layout)

    def plain_estimates(table3, cs_, t0=0, Tn=None):
        return tsk._sketch_estimates_plain(table3, cs_.inv_q, cs_.inv_w,
                                           cs_.sign_keys, t0)

    with mock.patch.object(tsk, "sketch_accumulate",
                           tsk._sketch_accumulate_plain), \
            mock.patch.object(tsk, "sketch_estimates", plain_estimates), \
            mock.patch.object(ttk, "topk_count_ge", ttk._count_ge_plain):
        before = kernels.launch_counts()
        upd_p, st_p = server_update(table, state, fm.server_config, lr,
                                    sketch=cs, layout=fm.layout)
        assert kernels.launch_counts() == before, "plain path launched"
    torch.cuda.synchronize()
    assert nan_equal(upd_k, upd_p), "server update: kernels != plain"
    assert nan_equal(st_k.velocity, st_p.velocity), "velocity differs"
    assert nan_equal(st_k.error, st_p.error), "error differs"
    nnz = int((upd_k != 0).sum())
    print(f"server phase exact: update ({nnz} nonzeros), velocity and "
          "error equal through kernels and plain versions")
    fm._round_table = None
    return counts, rps, split


def profile_rounds(one_round, n: int = 5) -> dict:
    """Device time by kernel over ``n`` rounds (torch.profiler), printed
    per round, and the device's busy share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one_round()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them would count the same time twice
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    cats = {"convolution": 0.0, "port kernels": 0.0, "other": 0.0}
    for e in rows:
        name = e.key.lower()
        if any(s in name for s in ("sketch_", "topk_count_ge")):
            cats["port kernels"] += dev_us(e)
        elif any(s in name for s in ("conv", "xmma", "cudnn", "dgrad",
                                     "wgrad", "implicit_gemm")):
            cats["convolution"] += dev_us(e)
        else:
            cats["other"] += dev_us(e)
    print(f"profile: {n} rounds, wall {wall_ms / n:.3f} ms/round under the "
          f"profiler, device busy {busy_ms / n:.3f} ms/round "
          f"({100 * busy_ms / wall_ms:.1f}%)")
    print("  by category (ms/round): " + json.dumps(
        {k: round(v / n / 1e3, 4) for k, v in cats.items()}))
    for e in rows[:16]:
        print(f"  {dev_us(e) / n / 1e3:8.3f} ms/round  {e.count / n:6.1f} "
              f"calls/round  {e.key[:90]}")
    return {"profiled_busy_ms_per_round": busy_ms / n,
            "profiled_wall_ms_per_round": wall_ms / n}


def phase_cv_train():
    """Phase 5: the CLI entry point, one short epoch and an eval."""
    from commefficient_torch import cv_train

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"] = "16"
        kernels.reset_launch_counts()
        summary = cv_train.main(HEADLINE + [
            "--dataset_dir", os.path.join(tmp, "cifar10"), "--iid",
            "--num_clients", "16", "--num_epochs", "1", "--seed", "0"])
        counts = kernels.launch_counts()
    assert summary and np.isfinite(summary["train_loss"]), summary
    assert all(v > 0 for v in counts.values()), counts
    print(f"cv_train row: {json.dumps(summary, default=float)}")
    print(f"cv_train launches: {json.dumps(counts)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    t_build = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    print(f"built {path.name} in {time.perf_counter() - t_build:.1f} s")
    for line in log.splitlines():
        if any(s in line for s in ("Compiling entry", "registers",
                                   "spill", "smem")):
            print("  ptxas: " + line.strip().removeprefix("ptxas info    : "))

    rows = {}
    for label, geom, timed in (
            ("headline", (6_568_640, 500_000, 5, 0, 0), True),
            ("ragged", (50_003, 3_001, 4, 2, 7), False),
            ("ragged-odd", (50_003, 3_001, 5, 0, 8), False)):
        d, c, r, t0, seed = geom
        res = check_kernels(card, d, c, r, t0, seed, label, timed)
        for name, row in res.items():
            line = {"phase": "kernels", "geometry": label, "name": name,
                    **row, "check_launches": kernels.launch_counts()[name]}
            print(json.dumps(line))
            if timed:
                rows[name] = row
    print(json.dumps({"kernels_checked": [k.name for k in kernels.KERNELS]}))

    counts, rps, split = phase_rounds()
    phase_cv_train()

    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": counts[k.name],
         "max_abs_err": rows[k.name]["max_abs_err"],
         "ms": rows[k.name]["ms"], "plain_ms": rows[k.name]["plain_ms"],
         "bound_ms": rows[k.name]["bound_ms"],
         "bound_by": rows[k.name]["bound_by"], "library_ms": None}
        for k in kernels.KERNELS]}
    print(json.dumps({"rounds_per_sec": rps,
                      "main_path_rounds": TIMED_ROUNDS, **split}))
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
