"""Heavy-hitter recovery of the chunked-cyclic sketch at FetchSGD scale,
against an ideal hash-based count sketch: the port's copy of the JAX
package's ``scripts/sketch_fidelity.py``.

Geometry: d = 6,568,640 (ResNet9's gradient), 5 rows x 500,000 columns,
k = 50,000, 20 blocks: the FetchSGD headline CIFAR10 config. The inputs
are power-law vectors (Zipf magnitudes, random signs, random placement),
drawn with numpy from seed ``100 + trial``; the sketch's geometry comes
from seed ``200 + trial``. The chunked-cyclic family runs through the
port's ``make_sketch`` / ``sketch_vec`` / ``unsketch`` on ``--device``
(on the card: the accumulate, the query and the count pass); the ideal
family and the metrics are numpy, as in the JAX script.

Per trial and family:
  - top-k mass recall: mass of the true top-k coordinates recovered /
    the true top-k mass
  - relative L2 error of the recovered k-sparse update against the true
    top-k vector
  - relative L2 error of the estimated values on the recovered part of
    the true support

Run on the card:  python -m commefficient_torch.scripts.sketch_fidelity
On the CPU:       python -m commefficient_torch.scripts.sketch_fidelity \\
                      --device cpu --trials 1
Writes ``--out`` (default ``runs/sketch_fidelity.json``). A trial's
``seconds`` include the host-to-device copy and, on its first call on the
card, the kernels' build.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from commefficient_torch.ops.sketch import make_sketch, sketch_vec, unsketch
from commefficient_torch.scripts.evidence import (
    add_common_args,
    device_record,
    resolve_device,
    write_json,
)

D = 6_568_640          # ResNet9 CIFAR10 grad size
R, C, K = 5, 500_000, 50_000
NUM_BLOCKS = 20
ALPHA = 1.1            # Zipf exponent
TRIALS = 3
FAMILIES = ("chunked-cyclic", "ideal-hash")


def powerlaw_vector(rng: np.random.RandomState, d: int) -> np.ndarray:
    mags = (np.arange(1, d + 1, dtype=np.float64)) ** (-ALPHA)
    signs = rng.choice([-1.0, 1.0], size=d)
    v = mags * signs
    rng.shuffle(v)
    return v.astype(np.float32)


def ideal_count_sketch(rng, v, r, c, k):
    """2-universal-ish (full random) hash count-sketch in numpy."""
    d = v.size
    est_rows = np.empty((r, d), np.float32)
    for j in range(r):
        buckets = rng.randint(0, c, size=d)
        signs = rng.choice([-1.0, 1.0], size=d).astype(np.float32)
        table = np.zeros(c, np.float32)
        np.add.at(table, buckets, v * signs)
        est_rows[j] = table[buckets] * signs
    est = np.median(est_rows, axis=0)
    idx = np.argpartition(np.abs(est), d - k)[d - k:]
    out = np.zeros(d, np.float32)
    out[idx] = est[idx]
    return out


def chunked_cyclic(v, r, c, k, seed, device="cuda"):
    """The k-sparse recovery of ``v`` through the port's sketch on
    ``device``: ``sketch_vec`` then ``unsketch``, as a numpy vector."""
    cs = make_sketch(v.size, c=c, r=r, seed=seed, num_blocks=NUM_BLOCKS,
                     device=device)
    table = sketch_vec(cs, torch.as_tensor(v, device=device))
    return unsketch(cs, table, k).cpu().numpy()


def metrics(v, recovered, k):
    d = v.size
    true_idx = np.argpartition(np.abs(v), d - k)[d - k:]
    true_topk = np.zeros(d, np.float32)
    true_topk[true_idx] = v[true_idx]
    true_mass = float(np.sum(v[true_idx] ** 2))

    rec_idx = np.flatnonzero(recovered)
    common = np.intersect1d(true_idx, rec_idx, assume_unique=False)
    recall_mass = float(np.sum(v[common] ** 2)) / true_mass

    rel_l2_update = float(np.linalg.norm(recovered - true_topk)
                          / np.linalg.norm(true_topk))
    rel_l2_vals = float(np.linalg.norm(recovered[common] - v[common])
                        / np.linalg.norm(v[common])) if common.size else np.nan
    return recall_mass, rel_l2_update, rel_l2_vals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, "sketch_fidelity")
    ap.add_argument("--trials", type=int, default=TRIALS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "sketch_fidelity")
    rows = []
    for trial in range(args.trials):
        rng = np.random.RandomState(100 + trial)
        v = powerlaw_vector(rng, D)

        t0 = time.time()
        rec_cc = chunked_cyclic(v, R, C, K, seed=200 + trial,
                                device=device.type)
        t_cc = time.time() - t0
        m_cc = metrics(v, rec_cc, K)

        t0 = time.time()
        rec_id = ideal_count_sketch(rng, v, R, C, K)
        t_id = time.time() - t0
        m_id = metrics(v, rec_id, K)

        rows.append(("chunked-cyclic", trial) + m_cc + (t_cc,))
        rows.append(("ideal-hash", trial) + m_id + (t_id,))
        print(f"trial {trial}: cc recall={m_cc[0]:.4f} relL2={m_cc[1]:.4f} "
              f"vals={m_cc[2]:.4f} ({t_cc:.1f}s) | ideal recall={m_id[0]:.4f} "
              f"relL2={m_id[1]:.4f} vals={m_id[2]:.4f} ({t_id:.1f}s)",
              flush=True)

    print("\nfamily            recall_mass  rel_l2_update  rel_l2_vals")
    means = {}
    for fam in FAMILIES:
        sel = [r for r in rows if r[0] == fam]
        rm = np.mean([r[2] for r in sel])
        ru = np.mean([r[3] for r in sel])
        rv = np.mean([r[4] for r in sel])
        means[fam] = {"recall_mass": float(rm), "rel_l2_update": float(ru),
                      "rel_l2_vals": float(rv)}
        print(f"{fam:<18} {rm:10.4f} {ru:13.4f} {rv:12.4f}")
    write_json(args.out, {
        "geometry": {"d": D, "r": R, "c": C, "k": K,
                     "num_blocks": NUM_BLOCKS, "alpha": ALPHA,
                     "trials": args.trials},
        **device_record(device),
        "rows": [dict(zip(("family", "trial", "recall_mass",
                           "rel_l2_update", "rel_l2_vals", "seconds"), r))
                 for r in rows],
        "means": means})
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
