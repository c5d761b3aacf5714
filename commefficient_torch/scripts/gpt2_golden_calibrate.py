"""Calibrate the GPT-2 sketched golden-trajectory envelope: the port's copy
of the JAX package's ``scripts/gpt2_golden_calibrate.py``, with the same
recipe.

The tiny GPT-2 (``COMMEFFICIENT_TINY_MODEL``, 64-token sequences) on the
synthetic PersonaChat of 16 clients, 4 workers, the 3 x 8,192 sketch with
k = 2,000, virtual momentum 0.9 and lr 0.08 peaking at epoch 2, through
``commefficient_torch.gpt2_train.train`` at each epoch budget given
(default 3 and 6), printing the final val NLL, accuracy and perplexity
of each. The JAX package's test of this recipe (``tests/test_gpt2.py``,
``TestGoldenTrajectory``) holds the 3-epoch val NLL below 5.0.

    python -m commefficient_torch.scripts.gpt2_golden_calibrate [epochs ...]

Writes ``--out`` (default ``runs/gpt2_golden_calibrate.json``): each
budget's stats, its wall seconds and the device. Each run's data and run
directory live in a temporary directory removed after it (the JAX script
leaves its run directory under ``runs/``); ``--device`` ends the argv.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

from commefficient_torch.scripts.evidence import (
    add_common_args,
    device_record,
    leg_env,
    resolve_device,
    write_json,
)

BUDGETS = (3.0, 6.0)


def run_argv(epochs, dataset_dir: str, seed: int = 0) -> list:
    """One budget's ``gpt2_train`` argv before ``--device``."""
    return [
        "--dataset_name", "PERSONA",
        "--dataset_dir", dataset_dir,
        "--num_epochs", str(epochs),
        "--num_workers", "4",
        "--local_batch_size", "4",
        "--valid_batch_size", "4",
        "--num_candidates", "2",
        "--mode", "sketch",
        "--num_rows", "3", "--num_cols", "8192", "--k", "2000",
        "--error_type", "virtual",
        "--local_momentum", "0",
        "--virtual_momentum", "0.9",
        "--lr_scale", "0.08", "--pivot_epoch", "2",
        "--seed", str(seed),
    ]


def run(epochs, seed: int = 0, device: str = "cuda") -> dict:
    """``gpt2_train.train`` at one budget; its val NLL, accuracy and
    perplexity."""
    from commefficient_torch import gpt2_train

    tmp = tempfile.mkdtemp(prefix="gpt2_golden_")
    try:
        with leg_env(tmp, "run", COMMEFFICIENT_SYNTHETIC_CLIENTS=16):
            stats = gpt2_train.train(argv=run_argv(
                epochs, os.path.join(tmp, "persona"), seed) + [
                "--device", device])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: float(stats[k]) for k in ("val_nll", "val_acc", "val_ppl")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("budgets", nargs="*", type=float,
                    help="epoch budgets (default: 3 6)")
    add_common_args(ap, "gpt2_golden_calibrate")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "gpt2_golden_calibrate")
    os.environ.setdefault("COMMEFFICIENT_TINY_MODEL", "1")
    os.environ.setdefault("COMMEFFICIENT_GPT2_SEQ_LEN", "64")
    record = device_record(device)
    out = {}
    for ep in args.budgets or BUDGETS:
        t0 = time.perf_counter()
        out[str(ep)] = dict(run(ep, device=device.type),
                            seconds=time.perf_counter() - t0, **record)
        print(f"epochs={ep}: {out[str(ep)]}", flush=True)
        write_json(args.out, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
