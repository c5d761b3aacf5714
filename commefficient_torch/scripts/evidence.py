"""What the port's learning-evidence scripts share: the device they run on
(the card unless the caller asks for the CPU), the card's name and power
limit for the record, the common flags, the per-leg run directory, and
the atomic write of the JSON a sweep resumes from.

The scripts (``sketch_fidelity``, ``learning_fullscale``,
``learning_midscale``, ``learning_async``, ``femnist_ablation``,
``gpt2_golden_calibrate``) are the port's copies of the JAX package's
``scripts/`` of the same names. Each writes its JSON to ``--out`` (by
default under the repo's ``runs/``, which git ignores) and never to
``docs/``."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RUNS = os.path.join(REPO, "runs")


def add_common_args(ap, name: str) -> None:
    """``--device``, ``--out`` (default ``runs/<name>.json``)."""
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; refused without a card) or cpu")
    ap.add_argument("--out", default=os.path.join(RUNS, f"{name}.json"),
                    help="the JSON written (and resumed from); default "
                         "%(default)s")


def add_run_args(ap) -> None:
    """``--data_root`` and ``--run_root`` of the ``cv_train`` sweeps."""
    ap.add_argument("--data_root", default=RUNS,
                    help="the directory that holds each leg's dataset "
                         "directory (default: the repo's runs/)")
    ap.add_argument("--run_root", default="",
                    help="put each leg's run directory (its "
                         "telemetry.jsonl) at <run_root>/<leg>; default: "
                         "cv_train's own runs/<time>_... name")


def resolve_device(name: str, script: str,
                   allow_cpu_env: str = "") -> torch.device:
    """The device a script runs on. ``cuda`` without a card exits with a
    message, never falling back to the CPU; ``cpu`` must be asked for,
    and where ``allow_cpu_env`` is named, also allowed by that variable
    set to 1."""
    if name == "cuda":
        if not torch.cuda.is_available():
            sys.exit(f"{script}: torch.cuda.is_available() is False; this "
                     "run needs an NVIDIA card (pass --device cpu to run "
                     "on the CPU)")
        return torch.device("cuda")
    if allow_cpu_env and os.environ.get(allow_cpu_env) != "1":
        sys.exit(f"{script}: refusing the run on the CPU; set "
                 f"{allow_cpu_env}=1 beside --device cpu to allow it")
    return torch.device("cpu")


def card_line() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line, or None
    where there is no ``nvidia-smi``."""
    from commefficient_torch.profiling import card_line as smi_line

    try:
        return smi_line()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_record(device: torch.device) -> dict:
    """Where a result was measured: the backend, the device's name and
    the card's ``nvidia-smi`` line (None on the CPU)."""
    if device.type == "cuda":
        return {"backend": "cuda", "device": torch.cuda.get_device_name(0),
                "card": card_line()}
    return {"backend": "cpu", "device": "cpu", "card": None}


def read_json(path: str) -> dict:
    """A sweep's earlier JSON, or ``{}`` where there is none or it does
    not parse."""
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except json.JSONDecodeError:
        print(f"previous artifact {path} unreadable; starting fresh",
              flush=True)
        return {}


def write_json(path: str, obj) -> None:
    """Atomic: an interrupt during the write keeps the previous file,
    and with it the legs a resumed sweep skips."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(path + ".tmp", path)


@contextlib.contextmanager
def leg_env(run_root: str, leg: str, **values):
    """Environment variables for one leg, restored after it: ``values``,
    and ``COMMEFFICIENT_RUN_DIR=<run_root>/<leg>`` where ``run_root`` is
    given."""
    if run_root:
        values["COMMEFFICIENT_RUN_DIR"] = os.path.join(run_root, leg)
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
