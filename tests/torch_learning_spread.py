"""The JAX package's side of a learning-rung spread study: the JAX
script ``scripts/learning_midscale.py``'s recipe for a leg, on its
8-device CPU mesh, at other seeds than the leg's own.

The JAX script runs each leg at one fixed seed and writes into ``docs/``;
this driver builds the same argv with the script's own ``common`` and
``LEGS`` (only ``--seed`` differs) and runs it through the JAX package's
``utils.run_cv_recorded``, writing the rows to ``--out``. The port's side
is ``python -m commefficient_torch.scripts.learning_midscale --seeds``.

    JAX_PLATFORMS=cpu python tests/torch_learning_spread.py \\
        big_uncompressed --seeds 1,2 --out spread_jax.json

Runs on the CPU only (it imports JAX), like the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "scripts"))
sys.path.insert(0, _REPO)

import learning_midscale as jlm  # noqa: E402  (pins the 8-device mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("legs", nargs="+", choices=sorted(jlm.LEGS))
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds for each leg's recipe")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from commefficient_tpu.utils import run_cv_recorded

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for leg in args.legs:
        channels, epochs, pivot, lr, own, extra, mode = jlm.LEGS[leg]
        for seed in (int(s) for s in args.seeds.split(",")):
            key = f"{leg}@seed{seed}"
            if key in results:
                continue
            argv_ = jlm.common(channels, epochs, pivot, lr, seed) \
                + extra + mode
            t0 = time.time()
            rows = run_cv_recorded(argv_, key)
            results[key] = {"channels": channels, "epochs": epochs,
                            "seed": seed, "argv": argv_, "rows": rows,
                            "package": "jax", "device": "cpu (8 devices)",
                            "wall_s": time.time() - t0}
            with open(args.out + ".tmp", "w") as f:
                json.dump(results, f, indent=1)
            os.replace(args.out + ".tmp", args.out)
            print(f"{key}: final test acc {rows[-1]['test_acc']:.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
