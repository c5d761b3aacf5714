"""Full-scale learning evidence on the card: the port's copy of the JAX
package's ``scripts/learning_fullscale.py``.

It trains the real FetchSGD CIFAR geometry (full ResNet9 with
``--batchnorm``, 8 workers x 64 images, the 5 x 500,000 sketch with
k = 50,000 and 20 blocks, virtual momentum 0.9) sketched against
uncompressed, on the same synthetic data (512 images a class, 10 rounds
an epoch) and seed, through ``commefficient_torch.cv_train``, and
records both legs' per-epoch rows.

    python -m commefficient_torch.scripts.learning_fullscale \\
        [--out PATH] [--run_root DIR] [--data_root DIR]

Knobs, as in the JAX script: ``LEARN_EPOCHS`` (24), ``LEARN_PIVOT`` (5),
``LEARN_TINY=1`` (a CPU-sized model and sketch, the same mechanics) and
``COMMEFFICIENT_SYNTHETIC_PER_CLASS`` (512). Legs resume from ``--out``
only when its geometry and backend match. The run needs a card: on a host
without one it stops, and it runs on the CPU only with ``--device cpu``
and ``COMMEFFICIENT_LEARNING_ALLOW_CPU=1`` both given. Each leg's argv
ends with ``--device``, which the JAX script has no counterpart of.
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
from commefficient_torch.utils import run_cv_recorded

PER_CLASS = "512"   # 5,120 train images: 10 rounds an epoch at 8 x 64


def tiny() -> bool:
    return os.environ.get("LEARN_TINY") == "1"


def epochs() -> str:
    return os.environ.get("LEARN_EPOCHS", "24")


def common(data_root: str = RUNS) -> list:
    return [
        "--dataset_name", "CIFAR10",
        "--dataset_dir", os.path.join(data_root, "learn_fullscale_data"),
        "--model", "ResNet9",
        "--batchnorm",
        "--iid", "--num_clients", "8",
        "--num_workers", "8",
        "--local_batch_size", "64",
        "--valid_batch_size", "64",
        "--num_epochs", epochs(),
        "--pivot_epoch", os.environ.get("LEARN_PIVOT", "5"),
        "--weight_decay", "5e-4",
        "--lr_scale", "0.4",
        "--seed", "0",
        # overlap host-side augmentation/assembly with device compute
        "--train_dataloader_workers", "1",
    ]


def sketch() -> list:
    small = tiny()
    return [
        "--mode", "sketch", "--error_type", "virtual",
        "--k", "2000" if small else "50000",
        "--num_cols", "16384" if small else "500000",
        "--num_rows", "5",
        "--num_blocks", "2" if small else "20",
        "--virtual_momentum", "0.9", "--local_momentum", "0",
    ]


UNCOMPRESSED = [
    "--mode", "uncompressed", "--error_type", "virtual",
    "--virtual_momentum", "0.9", "--local_momentum", "0",
]


def legs(data_root: str = RUNS) -> dict:
    """Each leg's ``cv_train`` argv before ``--device``, sketch first:
    it is the leg the evidence needs; uncompressed is the anchor."""
    return {"sketch": common(data_root) + sketch(),
            "uncompressed": common(data_root) + UNCOMPRESSED}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, "learning_fullscale")
    add_run_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "learning_fullscale",
                            allow_cpu_env="COMMEFFICIENT_LEARNING_ALLOW_CPU")
    os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", PER_CLASS)
    if tiny():
        os.environ["COMMEFFICIENT_TINY_MODEL"] = "1"
    else:
        os.environ.pop("COMMEFFICIENT_TINY_MODEL", None)  # full ResNet9
    record = device_record(device)
    print("backend:", record["backend"], record["device"], record["card"],
          flush=True)
    # legs resume only from a run of the same geometry on the same
    # backend: a LEARN_TINY or CPU artifact is never kept as evidence
    geometry = {"epochs": epochs(), "tiny": tiny(),
                "per_class": os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"],
                "backend": record["backend"]}
    out = dict(geometry, **record)
    prev = read_json(args.out)
    if prev:
        if all(prev.get(k) == v for k, v in geometry.items()):
            for tag in ("sketch", "uncompressed"):
                if prev.get(tag):
                    out[tag] = prev[tag]
                    print(f"leg {tag}: kept from previous run "
                          f"({len(prev[tag])} rows)", flush=True)
        else:
            prev_geo = {k: prev.get(k) for k in geometry}
            print(f"previous artifact geometry {prev_geo} != current "
                  f"{geometry}; re-running all legs", flush=True)
    for tag, leg_argv in legs(args.data_root).items():
        if out.get(tag):
            continue
        with leg_env(args.run_root, tag):
            out[tag] = run_cv_recorded(
                leg_argv + ["--device", device.type], tag)
        write_json(args.out, out)
        print(f"wrote {args.out} after {tag}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
