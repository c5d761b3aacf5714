"""The seeded rounds that the port's card tools drive: the FetchSGD
headline (ResNet9 on CIFAR10, BASELINE.md config 3) and GPT-2 double
heads on PersonaChat (config 5), each as a ``FedModel`` / ``FedOptimizer``
/ ``LambdaLR`` and a ``one_round(batch)`` closure, with a synthetic batch
made from a seed (no dataset, no network). The counterpart of the JAX
package's ``bench.py`` builders (``build``, ``build_gpt2``), which its
``scripts/tpu_profile.py`` calls; ``chip_smoke.py`` and
``scripts/round_profile.py`` build their rounds here.

Every builder takes ``device`` (default ``cuda``); the argv lists keep
``--device cuda`` and the builder swaps the value in.
"""

from __future__ import annotations

import numpy as np
import torch

from commefficient_torch.config import parse_args
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR
from commefficient_torch.federated.losses import (
    make_cv_losses,
    make_gpt2_losses,
)
from commefficient_torch.models import GPT2DoubleHeads, ResNet9
from commefficient_torch.utils import PiecewiseLinear

HEADLINE = ["--mode", "sketch", "--error_type", "virtual",
            "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
            "--num_workers", "8", "--local_batch_size", "8",
            "--dataset_name", "CIFAR10", "--device", "cuda",
            "--no_telemetry"]
# the JAX bench's CPU geometry (``bench.py``: TINY_CHANNELS, a 3 x 8,192
# sketch, k = 512), for a self-test of the tools on the CPU
TINY_CHANNELS = (("prep", 8), ("layer1", 16), ("layer2", 16),
                 ("layer3", 32))
TINY_SKETCH = ["--num_rows", "3", "--num_cols", "8192", "--k", "512"]

GPT2_D = 124_444_417
GPT2_MODEL = {"vocab_size": 50_262, "n_positions": 1024}
GPT2_W, GPT2_B, GPT2_C, GPT2_T = 4, 2, 2, 256
GPT2_BASE = ["--mode", "sketch", "--error_type", "virtual",
             "--local_momentum", "0", "--virtual_momentum", "0.9",
             "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
             "--num_blocks", "20", "--num_workers", str(GPT2_W),
             "--local_batch_size", str(GPT2_B),
             "--num_candidates", str(GPT2_C), "--max_seq_len", str(GPT2_T),
             "--valid_batch_size", "2", "--device", "cuda", "--seed", "0",
             "--no_telemetry"]


def on_device(argv, device: str):
    """``argv`` with the value of its ``--device`` set to ``device``."""
    argv = list(argv)
    argv[argv.index("--device") + 1] = str(device)
    return argv


def synthetic_batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(8, 8, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(8, 8)).astype(np.int64),
            "mask": np.ones((8, 8), np.float32),
            "client_ids": np.arange(8, dtype=np.int32),
            "worker_mask": np.ones(8, np.float32)}


def _round_of(fm, opt, sched):
    def one_round(batch):
        sched.step()
        out = fm(batch)
        opt.step()
        return out

    return one_round


def build_round(extra, num_clients: int = 64, device: str = "cuda",
                tiny: bool = False):
    """FedModel / FedOptimizer / LambdaLR for the headline round plus the
    flags ``extra``; returns ``(args, fm, opt, sched, one_round)``.
    ``tiny``: the JAX bench's CPU geometry (ResNet9 at TINY_CHANNELS and
    a 3 x 8,192 sketch, k = 512)."""
    args = parse_args(argv=on_device(HEADLINE, device) + extra + (
        TINY_SKETCH if tiny else []) + [
        "--num_clients", str(num_clients), "--seed", "0"])
    model = (ResNet9(channels=TINY_CHANNELS, do_batchnorm=args.do_batchnorm)
             if tiny else ResNet9(do_batchnorm=args.do_batchnorm))
    train_loss, val_loss = make_cv_losses(model)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients)
    opt = FedOptimizer(fm, args)
    spe = 50
    schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                               [0, 0.4, 0])
    sched = LambdaLR(opt, lambda step: schedule(step / spe))
    print(f"model d = {fm.grad_size:,}, sketch {fm.sketch.r} x "
          f"{fm.sketch.c_pad} (T = {fm.sketch.T}), k = {args.k}")
    return args, fm, opt, sched, _round_of(fm, opt, sched)


def gpt2_batch(seed: int = 0):
    """A seeded synthetic GPT-2 round (bench.py's): W clients x B examples
    x C candidates x T tokens of ids below 50,000."""
    rng = np.random.RandomState(seed)
    W, B, C, T = GPT2_W, GPT2_B, GPT2_C, GPT2_T
    return {
        "input_ids": rng.randint(0, 50000, (W, B, C, T)).astype(np.int64),
        "token_type_ids": rng.randint(0, 50000, (W, B, C, T)).astype(
            np.int64),
        "lm_labels": rng.randint(0, 50000, (W, B, C, T)).astype(np.int64),
        "mc_token_ids": rng.randint(0, T, (W, B, C)).astype(np.int64),
        "mc_labels": rng.randint(0, C, (W, B)).astype(np.int64),
        "mask": np.ones((W, B), np.float32),
        "client_ids": np.arange(W, dtype=np.int32),
        "worker_mask": np.ones(W, np.float32)}


def build_gpt2(extra, num_clients: int = 8, device: str = "cuda"):
    """FedModel / FedOptimizer / LambdaLR for the GPT-2 round plus the
    flags ``extra``; returns ``(args, fm, opt, sched, one_round)``."""
    args = parse_args(default_lr=4e-2, argv=on_device(GPT2_BASE, device)
                      + extra + ["--dataset_name", "PERSONA",
                                 "--num_clients", str(num_clients)])
    model = GPT2DoubleHeads(**GPT2_MODEL)
    train_loss, val_loss = make_gpt2_losses(
        model, compute_dtype=torch.bfloat16 if args.do_bf16 else None)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients)
    assert fm.grad_size == GPT2_D, fm.grad_size
    opt = FedOptimizer(fm, args)
    schedule = PiecewiseLinear([0, 100], [args.lr_scale, 0.0])
    sched = LambdaLR(opt, lambda step: schedule(step))
    print(f"gpt2 d = {fm.grad_size:,}, sketch {fm.sketch.r} x "
          f"{fm.sketch.c_pad} (T = {fm.sketch.T}), k = {args.k}")
    return args, fm, opt, sched, _round_of(fm, opt, sched)
