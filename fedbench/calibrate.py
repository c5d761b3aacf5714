"""The readings a cell's limits are set from (``fedbench/limits/``), taken
on the card at the cell's own size; no measured window.

    python3 -m fedbench.calibrate --workload NAME --seeds 1,2,3 \\
        [--faults 1,2,3] [--out FILE.jsonl]

For each seed of ``--seeds``: the program's three checked rounds through
the round engine, as a run takes them, against the reference (``sound``).
For each seed of ``--faults`` besides: the control, the reference in the
program's place one precision below the configuration's (float32 with
TF32 on), against the reference (``control``); and the fault of half the
batch left out, the mean taken over the rest, planted in the reference
put in the program's place (``half_batch``). A step that returns its
state unchanged reads 1 on ``grad_gap`` and ``change_gap`` by the
measure itself and needs no run. One JSON line a seed.

    python3 -m fedbench.calibrate --workload NAME --limits FILE.jsonl

prints the cell's limits file (``fedbench/limits/<cell>.json``) from the
readings of FILE.jsonl by the rule of ``limits``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import tempfile

import numpy as np
import torch

from fedbench import check, harness, spec, traffic


def readings(c: spec.Cell, seed: int, device: str = "cuda",
             faults: bool = False) -> dict:
    s = harness.seeds(seed)
    pool = traffic.rounds(c.traffic, s.data)
    with tempfile.TemporaryDirectory(prefix="fedbench-") as log_dir:
        p = harness.Program(c, s, device, log_dir)
        prog = harness.first_rounds(p, pool)
        p.close()
        del p
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = harness.reference_rounds(c, s, pool, device)
    moved_p = prog["weights"] != ref["w0"]
    moved_r = ref["weights"] != ref["w0"]
    out = {"workload": c.name, "seed": seed,
           "sound": harness.compare(prog, ref),
           # why a seed reads high: the coordinates one side moved and the
           # other did not
           "moved_differ": int((moved_p ^ moved_r).sum()),
           "moved": int(moved_r.sum()),
           "leaves_left_out": int((ref["grad_leaf_norms"] < check.GRAD_FLOOR
                                   * np.median(ref["grad_leaf_norms"])).sum())}
    if faults:
        ctl = harness.reference_rounds(c, s, pool, device, tf32=True)
        out["control"] = harness.compare(ctl, ref)
        half = harness.reference_rounds(
            c, s, pool, device,
            drop_clients=int(c.traffic["clients_per_round"]) // 2)
        out["half_batch"] = harness.compare(half, ref)
    return out


def _nice(x: float) -> float:
    """``x`` to the nearest of 1, 2 and 5 times a power of ten (in log)."""
    e = math.floor(math.log10(x))
    m = min((1, 2, 5, 10), key=lambda c: abs(math.log(x / 10**e / c)))
    return float(f"{m * 10**e:.1g}")


def limits(lines: list) -> dict:
    """A cell's limits from its readings: for each number, the lower
    reading L, the largest of the sound runs; the upper U, the least of
    the control's least reading where that is 3 L or more, and of each
    fault's least where that is 10 L or more (a state left unchanged
    reads 1 on ``grad_gap`` and ``change_gap``, counted at 3 L); and the
    limit, nearer the upper in log: L^0.4 U^0.6, or U / 10 where L is 0,
    to the nearest of 1, 2 and 5 times a power of ten, or to two
    significant digits where that would fall under sqrt(L U) or reach U.
    A number with no upper reading raises."""
    out, set_from = {}, {}
    sound = [r["sound"] for r in lines]
    faulted = [r for r in lines if "control" in r]
    for name in (n for n in check.NAMES if n in sound[0]):
        lo = max(float(r[name]) for r in sound)
        ctl = min(float(r["control"][name]) for r in faulted)
        half = min(float(r["half_batch"][name]) for r in faulted)
        cands = [(ctl, "control (TF32 on)")] if ctl >= 3 * lo else []
        if half >= 10 * lo:
            cands.append((half, "half of the batch left out"))
        if name in ("grad_gap", "change_gap") and 1.0 >= 3 * lo:
            cands.append((1.0, "the state left unchanged"))
        cands = [c for c in cands if c[0] > 0]
        if not cands:
            raise ValueError(f"{name}: no upper reading (lower {lo}, "
                             f"control {ctl}, half batch {half})")
        up, src = min(cands)
        lim = up / 10 if lo == 0 else lo**0.4 * up**0.6
        val = _nice(lim)
        if not math.sqrt(lo * up) <= val < up:
            val = float(f"{lim:.2g}")
        out[name] = val
        set_from[name] = {"lower": lo, "sound_runs": len(sound),
                          "upper": up, "upper_from": src,
                          "control_least": ctl, "half_batch_least": half}
    out["set_from"] = set_from
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--limits", default="")
    a = ap.parse_args(argv)
    if a.limits:
        with open(a.limits) as f:
            lines = [r for r in map(json.loads, f)
                     if r["workload"] == a.workload]
        print(json.dumps(limits(lines), indent=2))
        return 0
    if not torch.cuda.is_available():
        print("fedbench.calibrate: no CUDA device", file=sys.stderr)
        return 3
    c = spec.cell(a.workload)
    plan = [(int(x), False) for x in a.seeds.split(",") if x] + \
        [(int(x), True) for x in a.faults.split(",") if x]
    for seed, faults in plan:
        line = json.dumps(readings(c, seed, faults=faults))
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
