"""The async-buffered learning rung, accuracy against ``--async_buffer K``
x ``--staleness_decay``: the port's copy of the JAX package's
``scripts/learning_async.py``, with the same legs.

At the learning ladder's anchor (``--batchnorm`` ResNet9 at 12/24/48/96
channels, d = 232,812, a 5 x 8,192 sketch with k = 2,000, 16 iid clients,
synthetic CIFAR10 at 64 images a class, 12 epochs):

- ``sync``: the K = 0 anchor (no async plane);
- ``sync_slow``: the anchor under 20% injected stragglers landing 2
  rounds late;
- ``k2_d5 k2_d8 k4_d5 k4_d8``: ``--async_buffer`` {2, 4} x
  ``--staleness_decay`` {0.5, 0.8} under the same stragglers, so every
  buffered fold carries stale contributions.

    python -m commefficient_torch.scripts.learning_async [legs...]

Each completed leg is added to ``--out`` (default
``runs/learning_async.json``); re-run with the remaining legs to resume.
As in ``learning_midscale``, ``--num_devices`` is 1 where the JAX legs
give the 8 of their CPU mesh, and ``--device`` ends the argv.
"""

from __future__ import annotations

import argparse
import os

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
from commefficient_torch.scripts.learning_midscale import (
    GOLDEN_CHANNELS,
    NUM_DEVICES,
    PER_CLASS,
)
from commefficient_torch.utils import run_cv_recorded

# 20% slow slots, landing 2 rounds late: every ~K-th fold then carries a
# version-tagged stale contribution, so the decay sweep measures a real
# effect, not w(0) = 1 no-ops
SLOW = ["--inject_client_fault", "slow=0.2,delay=2,seed=7"]


def common(epochs, seed, data_root=RUNS):
    return [
        "--dataset_name", "CIFAR10",
        "--dataset_dir", os.path.join(data_root, "learn_async_data"),
        "--model", "ResNet9", "--batchnorm",
        "--num_workers", "8", "--num_devices", NUM_DEVICES,
        "--local_batch_size", "16",
        "--valid_batch_size", "50",
        "--num_epochs", str(epochs), "--pivot_epoch", "2",
        "--lr_scale", "0.3",
        "--local_momentum", "0",
        "--seed", str(seed),
        "--iid", "--num_clients", "16",
    ]


SKETCH = ["--mode", "sketch", "--error_type", "virtual",
          "--k", "2000", "--num_cols", "8192", "--num_rows", "5",
          "--num_blocks", "2", "--virtual_momentum", "0.9"]


def _async(k, decay):
    return SLOW + ["--async_buffer", str(k),
                   "--staleness_decay", str(decay)]


# leg -> (epochs, seed, extra argv)
LEGS = {
    "sync": (12, 0, []),
    "sync_slow": (12, 0, SLOW),
    "k2_d5": (12, 0, _async(2, 0.5)),
    "k2_d8": (12, 0, _async(2, 0.8)),
    "k4_d5": (12, 0, _async(4, 0.5)),
    "k4_d8": (12, 0, _async(4, 0.8)),
}


def leg_argv(leg: str, data_root: str = RUNS) -> list:
    """The leg's ``cv_train`` argv before ``--device``."""
    epochs, seed, extra = LEGS[leg]
    return common(epochs, seed, data_root) + SKETCH + extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("legs", nargs="*",
                    help=f"of {', '.join(LEGS)} (default: all)")
    add_common_args(ap, "learning_async")
    add_run_args(ap)
    args = ap.parse_args(argv)
    if set(args.legs) - set(LEGS):
        ap.error(f"unknown legs {sorted(set(args.legs) - set(LEGS))}")
    device = resolve_device(args.device, "learning_async")
    os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", PER_CLASS)
    record = device_record(device)
    results = read_json(args.out)
    for leg in args.legs or list(LEGS):
        epochs, seed, _ = LEGS[leg]
        argv_ = leg_argv(leg, args.data_root) + ["--device", device.type]
        print(f"=== {leg}: channels {GOLDEN_CHANNELS} epochs {epochs} "
              f"seed {seed} ===", flush=True)
        with leg_env(args.run_root, leg,
                     COMMEFFICIENT_MODEL_CHANNELS=GOLDEN_CHANNELS):
            rows = run_cv_recorded(argv_, leg)
        results[leg] = {"channels": GOLDEN_CHANNELS, "epochs": epochs,
                        "seed": seed, "argv": argv_, "rows": rows, **record}
        write_json(args.out, results)
        print(f"leg {leg} done -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
