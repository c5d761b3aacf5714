"""The learning rungs between d = 232,812 and d = 6.5M: the port's copy of
the JAX package's ``scripts/learning_midscale.py``, with the same legs.

The FetchSGD recipe (``--batchnorm`` ResNet9, virtual momentum 0.9,
synthetic CIFAR10 at 64 images a class) at ResNet9 widths that keep the
compression honest: 24/48/96/192 channels (d = 911,754) with a 5 x 65,536
sketch and k = 8,000 (2.8x), 48/96/192/384 (d = 3,699,504) with 5 x
262,144 and k = 25,000, each with its uncompressed anchor; and the
round-4 headline rows at d = 232,812 (12/24/48/96) at seeds 0 and 1:
5.7x at 24 epochs, and non-IID at 40.

    python -m commefficient_torch.scripts.learning_midscale [legs...]

Legs: mid_sketch mid_uncompressed big_sketch big_uncompressed seed0_5p7
seed1_5p7 seed0_noniid seed1_noniid (default: all). Each completed leg is
added to ``--out`` (default ``runs/learning_midscale.json``), so an
interrupted sweep resumes by re-running with the remaining legs.

A spread study: ``--seeds 0,1,2`` runs each named leg's recipe at each of
those seeds instead of its own (keyed ``<leg>@seed<S>`` in ``--out``);
``--deterministic`` holds cuDNN to deterministic algorithms with no
autotuning, so that a repeat on the card shows the card's own drift. Both
leave the legs' recipes as they are.

The argv differs from the JAX script's in two flags. ``--num_devices``
is 1, not 8: the JAX legs spread the 8 client slots over the 8-device
CPU mesh that ``scripts/script_env.force_cpu_mesh`` pins, and the port
runs them in one process on one device. ``--device`` (the card unless
``--device cpu`` is given) ends the argv.
"""

from __future__ import annotations

import argparse
import os

import torch

from commefficient_torch.scripts.evidence import (
    RUNS,
    add_common_args,
    add_run_args,
    device_record,
    leg_env,
    read_json,
    resolve_device,
    write_json,
)
from commefficient_torch.utils import run_cv_recorded

PER_CLASS = "64"
# the JAX legs' value is 8, the devices of its CPU mesh (module docstring)
NUM_DEVICES = "1"

# d = 911,754 at 24/48/96/192 channels; 5x65536 cells = 2.78x compression
MID_CHANNELS = "24,48,96,192"
GOLDEN_CHANNELS = "12,24,48,96"  # d = 232,812 (the round-4 headline rows)
BIG_CHANNELS = "48,96,192,384"  # d = 3,699,504 — over half full geometry


def common(epochs, pivot, lr, seed, data_root=RUNS):
    return [
        "--dataset_name", "CIFAR10",
        "--dataset_dir", os.path.join(data_root, "learn_midscale_data"),
        "--model", "ResNet9", "--batchnorm",
        "--num_workers", "8", "--num_devices", NUM_DEVICES,
        "--local_batch_size", "16",
        "--valid_batch_size", "50",
        "--num_epochs", str(epochs), "--pivot_epoch", str(pivot),
        "--lr_scale", str(lr),
        "--local_momentum", "0",
        "--seed", str(seed),
    ]


SKETCH_MID = ["--mode", "sketch", "--error_type", "virtual",
              "--k", "8000", "--num_cols", "65536", "--num_rows", "5",
              "--num_blocks", "4", "--virtual_momentum", "0.9"]
UNCOMP = ["--mode", "uncompressed", "--error_type", "virtual",
          "--virtual_momentum", "0.9"]
# the round-4 headline configs, re-run at seed 1 (docs/learning_curves.md)
SKETCH_5P7 = ["--mode", "sketch", "--error_type", "virtual",
              "--k", "2000", "--num_cols", "8192", "--num_rows", "5",
              "--num_blocks", "2", "--virtual_momentum", "0.9"]
SKETCH_NONIID = ["--mode", "sketch", "--error_type", "virtual",
                 "--k", "3000", "--num_cols", "16384", "--num_rows", "5",
                 "--num_blocks", "2", "--virtual_momentum", "0.9"]
SKETCH_BIG = ["--mode", "sketch", "--error_type", "virtual",
              "--k", "25000", "--num_cols", "262144", "--num_rows", "5",
              "--num_blocks", "8", "--virtual_momentum", "0.9"]

IID16 = ["--iid", "--num_clients", "16"]
# leg -> (channels, epochs, pivot, lr, seed, extra argv, mode argv)
LEGS = {
    "mid_sketch": (MID_CHANNELS, 20, 3, 0.3, 0, IID16, SKETCH_MID),
    "big_sketch": (BIG_CHANNELS, 16, 3, 0.3, 0, IID16, SKETCH_BIG),
    "big_uncompressed": (BIG_CHANNELS, 8, 2, 0.15, 0, IID16, UNCOMP),
    "mid_uncompressed": (MID_CHANNELS, 10, 2, 0.15, 0, IID16, UNCOMP),
    "seed0_5p7": (GOLDEN_CHANNELS, 24, 2, 0.3, 0, IID16, SKETCH_5P7),
    "seed1_5p7": (GOLDEN_CHANNELS, 24, 2, 0.3, 1, IID16, SKETCH_5P7),
    "seed0_noniid": (GOLDEN_CHANNELS, 40, 5, 0.3, 0,
                     ["--num_clients", "10"], SKETCH_NONIID),
    "seed1_noniid": (GOLDEN_CHANNELS, 40, 5, 0.3, 1,
                     ["--num_clients", "10"], SKETCH_NONIID),
}


def leg_argv(leg: str, data_root: str = RUNS, seed=None) -> list:
    """The leg's ``cv_train`` argv before ``--device`` (at ``seed`` when
    given, else the leg's own); its channels go in
    ``COMMEFFICIENT_MODEL_CHANNELS``."""
    _, epochs, pivot, lr, own, extra, mode = LEGS[leg]
    return (common(epochs, pivot, lr, own if seed is None else seed,
                   data_root) + extra + mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("legs", nargs="*",
                    help=f"of {', '.join(LEGS)} (default: all)")
    add_common_args(ap, "learning_midscale")
    add_run_args(ap)
    ap.add_argument("--seeds", default="",
                    help="comma-separated seeds: run each leg's recipe at "
                         "these seeds instead of its own (a spread study)")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN on deterministic algorithms, no autotuning")
    args = ap.parse_args(argv)
    if set(args.legs) - set(LEGS):
        ap.error(f"unknown legs {sorted(set(args.legs) - set(LEGS))}")
    device = resolve_device(args.device, "learning_midscale")
    os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", PER_CLASS)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    record = device_record(device)
    record["cudnn_deterministic"] = bool(
        torch.backends.cudnn.deterministic)
    seeds = [int(x) for x in args.seeds.split(",") if x.strip()]
    results = read_json(args.out)
    for leg in args.legs or list(LEGS):
        channels, epochs, _, _, own, _, _ = LEGS[leg]
        for seed in seeds or [None]:
            key = leg if seed is None else f"{leg}@seed{seed}"
            argv_ = (leg_argv(leg, args.data_root, seed)
                     + ["--device", device.type])
            print(f"=== {key}: channels {channels} epochs {epochs} seed "
                  f"{own if seed is None else seed} ===", flush=True)
            with leg_env(args.run_root, key,
                         COMMEFFICIENT_MODEL_CHANNELS=channels):
                rows = run_cv_recorded(argv_, key)
            results[key] = {"channels": channels, "epochs": epochs,
                            "seed": own if seed is None else seed,
                            "argv": argv_, "rows": rows, **record}
            write_json(args.out, results)
            print(f"leg {key} done -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
