"""The FEMNIST sketched-generalization sample-count ablation: the port's
copy of the JAX package's ``scripts/femnist_ablation.py``, with the same
runs.

It sweeps the synthetic writers' samples a client
(``COMMEFFICIENT_SYNTHETIC_SAMPLES``, from ``FEMNIST_SAMPLES``, default
40,160,640) for the sketched config (5 x 16,384, k = 4,000, lr 0.25) and
its uncompressed anchor (lr 0.1) on the tiny ``--batchnorm`` ResNet9 over
50 synthetic writers: the sketched test accuracy should close on the
uncompressed one as data grows. 16 epochs up to 160 samples, 12 above
(``FEMNIST_EPOCHS`` overrides); ``FEMNIST_SKETCH_LR`` sweeps the sketched
lr (a non-default value gets lr-tagged keys).

    python -m commefficient_torch.scripts.femnist_ablation

Each completed run is added to ``--out`` (default
``runs/femnist_ablation.json``), which a re-run resumes from. Each
setting prepares its own dataset directory under ``--data_root``,
fingerprinted by ``fed_emnist.SYNTHETIC_GEN_VERSION``. ``--device`` ends
each run's argv, which the JAX script's has no counterpart of.
"""

from __future__ import annotations

import argparse
import os

from commefficient_torch.data_utils.fed_emnist import SYNTHETIC_GEN_VERSION
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


def sample_grid() -> list:
    return [int(s) for s in
            os.environ.get("FEMNIST_SAMPLES", "40,160,640").split(",")]


def epochs_for(samples: int) -> int:
    """16 epochs up to s=160, 12 at larger settings (a constant-rounds
    budget undertrained both modes at s=160)."""
    if os.environ.get("FEMNIST_EPOCHS"):
        return int(os.environ["FEMNIST_EPOCHS"])
    return 16 if samples <= 160 else 12


def sketch_lr() -> str:
    return os.environ.get("FEMNIST_SKETCH_LR", "0.25")


def sketch() -> list:
    return [
        "--mode", "sketch", "--error_type", "virtual",
        "--k", "4000", "--num_cols", "16384", "--num_rows", "5",
        "--num_blocks", "2",
        "--virtual_momentum", "0.9", "--local_momentum", "0",
        "--lr_scale", sketch_lr(),
    ]


UNCOMPRESSED = [
    "--mode", "uncompressed", "--error_type", "virtual",
    "--virtual_momentum", "0.9", "--local_momentum", "0",
    "--lr_scale", "0.1",
]


def run_argv(samples: int, mode_args, data_root: str = RUNS) -> list:
    """One run's ``cv_train`` argv before ``--device``."""
    ep = epochs_for(samples)
    return [
        "--dataset_name", "EMNIST",
        # samples are read at dataset prepare time: one dir per setting,
        # fingerprinted by the generator version, since a prepared
        # directory keeps its clients
        "--dataset_dir", os.path.join(
            data_root,
            f"femnist_ablation_g{SYNTHETIC_GEN_VERSION}_s{samples}"),
        "--model", "ResNet9", "--batchnorm",
        "--num_workers", "8",
        "--local_batch_size", "16",
        "--valid_batch_size", "64",
        "--num_epochs", str(ep),
        "--pivot_epoch", str(max(1, ep // 4)),
        "--seed", "0",
        # overlap host-side augmentation/assembly with device compute
        "--train_dataloader_workers", "1",
    ] + list(mode_args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, "femnist_ablation")
    add_run_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "femnist_ablation")
    os.environ.setdefault("COMMEFFICIENT_TINY_MODEL", "1")
    os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_CLIENTS", "50")
    record = device_record(device)
    out = read_json(args.out)
    for samples in sample_grid():
        for tag, mode_args in (("sketch", sketch()),
                               ("uncompressed", UNCOMPRESSED)):
            key = f"{tag}_s{samples}"
            if tag == "sketch" and sketch_lr() != "0.25":
                key = f"sketch_lr{sketch_lr()}_s{samples}"
            if out.get(key):
                print(f"skip {key}: already recorded", flush=True)
                continue
            argv_ = run_argv(samples, mode_args, args.data_root) + [
                "--device", device.type]
            with leg_env(args.run_root, key,
                         COMMEFFICIENT_SYNTHETIC_SAMPLES=samples):
                rows = run_cv_recorded(argv_, f"{tag} s={samples}")
            # provenance lives with each run, so a resumed sweep under
            # other settings cannot mislabel earlier entries
            out[key] = {"rows": rows, "samples": samples,
                        "epochs": epochs_for(samples),
                        "clients": int(os.environ[
                            "COMMEFFICIENT_SYNTHETIC_CLIENTS"]),
                        **record}
            write_json(args.out, out)
            print(f"wrote {args.out} after {tag} s={samples}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
