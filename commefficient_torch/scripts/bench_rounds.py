"""The seeded rounds that the port's card tools drive: the FetchSGD
headline (ResNet9 on CIFAR10, BASELINE.md config 3) and GPT-2 double
heads on PersonaChat (config 5), each as a ``FedModel`` / ``FedOptimizer``
/ ``LambdaLR`` and a ``one_round(batch)`` closure, with a synthetic batch
made from a seed (no dataset, no network). The counterpart of the JAX
package's ``bench.py`` builders (``build``, ``build_gpt2``), which its
``scripts/tpu_profile.py`` and ``scripts/tpu_measure.py`` call;
``chip_smoke.py``, ``scripts/round_profile.py`` and
``scripts/card_measure.py`` build their rounds here. Also the headline
round's batch at a population (``cohort_batch``, for the client-state
tiers), the sketch-local round with its client rows on a tier
(``build_offload``) and its rounds through the round engine
(``engine_rounds``), the other CV models' rounds (``build_cv``, with the
ImageNet FixupResNet50 flags of ``imagenet_argv``), and the timed window
of rounds the tools read their rates from (``time_rounds``).

Every builder takes ``device`` (default ``cuda``); the argv lists keep
``--device cuda`` and the builder swaps the value in.
"""

from __future__ import annotations

import time
from unittest import mock

import numpy as np
import torch

from commefficient_torch import kernels
from commefficient_torch.checks import env_vars
from commefficient_torch.config import parse_args
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR
from commefficient_torch.federated.losses import (
    make_cv_losses,
    make_gpt2_losses,
)
from commefficient_torch.models import GPT2DoubleHeads, ResNet9
from commefficient_torch.ops.flat import ChunkLayout
from commefficient_torch.utils import PiecewiseLinear

RESNET9_D = 6_568_640
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


# the sketch-local headline round (local momentum 0.9 and error, a 5 x
# 500,000 table a client a row kind) whose client rows go to a tier
OFFLOAD_BASE = ["--mode", "sketch", "--error_type", "local",
                "--local_momentum", "0.9", "--virtual_momentum", "0",
                "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
                "--num_workers", "8", "--local_batch_size", "8",
                "--dataset_name", "CIFAR10", "--device", "cuda",
                "--no_telemetry", "--seed", "0"]


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


def cohort_batch(seed: int, n_clients: int, live: int = 8):
    """A headline round of 8 slots at a population of ``n_clients``:
    ``live`` clients drawn without replacement, the rest padding (client
    0, zero masks), as the loader pads a short cohort."""
    rng = np.random.RandomState(1000 + seed)
    b = {"inputs": rng.randn(8, 8, 32, 32, 3).astype(np.float32),
         "targets": rng.randint(0, 10, size=(8, 8)).astype(np.int64),
         "mask": np.ones((8, 8), np.float32),
         "client_ids": rng.choice(n_clients, 8, replace=False)
         .astype(np.int32),
         "worker_mask": np.ones(8, np.float32)}
    b["mask"][live:] = 0.0
    b["worker_mask"][live:] = 0.0
    b["client_ids"][live:] = 0
    return b


def build_round(extra, num_clients: int = 64, device: str = "cuda",
                tiny: bool = False, group=None):
    """FedModel / FedOptimizer / LambdaLR for the headline round plus the
    flags ``extra``; returns ``(args, fm, opt, sched, one_round)``.
    ``tiny``: the JAX bench's CPU geometry (ResNet9 at TINY_CHANNELS and
    a 3 x 8,192 sketch, k = 512). ``group``: the model's
    ``parallel.ClientGroup``."""
    args = parse_args(argv=on_device(HEADLINE, device) + extra + (
        TINY_SKETCH if tiny else []) + [
        "--num_clients", str(num_clients), "--seed", "0"])
    model = (ResNet9(channels=TINY_CHANNELS, do_batchnorm=args.do_batchnorm)
             if tiny else ResNet9(do_batchnorm=args.do_batchnorm))
    train_loss, val_loss = make_cv_losses(model)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients,
                  group=group)
    opt = FedOptimizer(fm, args)
    spe = 50
    schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                               [0, 0.4, 0])
    sched = LambdaLR(opt, lambda step: schedule(step / spe))
    sk = fm.sketch
    print(f"model d = {fm.grad_size:,}, " + (
        f"sketch {sk.r} x {sk.c_pad} (T = {sk.T}), k = {args.k}"
        if sk is not None else f"mode {args.mode}"))
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


def imagenet_argv(W: int = 7, BS: int = 64, microbatch: int = 16,
                  device: str = "cuda"):
    """scripts/imagenet.sh's round: FixupResNet50, ``W`` clients of ``BS``
    images, uncompressed, virtual momentum 0.9, weight decay 1e-4, in
    microbatches of ``microbatch``."""
    return ["--mode", "uncompressed", "--error_type", "none",
            "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--weight_decay", "1e-4", "--num_workers", str(W),
            "--local_batch_size", str(BS), "--microbatch_size",
            str(microbatch), "--dataset_name", "ImageNet", "--model",
            "FixupResNet50", "--iid", "--num_clients", str(W), "--device",
            str(device), "--seed", "0", "--no_telemetry"]


def build_cv(argv, num_clients: int):
    """FedModel / FedOptimizer / LambdaLR for the round of ``argv``, the
    model and the LR groups as ``cv_train`` builds them; returns ``(args,
    fm, opt, sched, one_round)``."""
    from commefficient_torch import cv_train

    args = parse_args(argv=list(argv))
    model = cv_train.build_model_and_config(args)
    cv_train.check_trainable(model)
    train_loss, val_loss = make_cv_losses(
        model, compute_dtype=torch.bfloat16 if args.do_bf16 else None)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients)
    opt = FedOptimizer(fm, args, param_groups=cv_train.build_param_groups(
        args, fm.param_layout))
    schedule = PiecewiseLinear([0, 100], [0.1, 0.0])
    sched = LambdaLR(opt, lambda step: schedule(step))
    return args, fm, opt, sched, _round_of(fm, opt, sched)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_rounds(one_round, batch, n: int) -> dict:
    """2 warm-up rounds, then ``n`` rounds on the host clock ending in a
    device sync, the kernels' launch counts set to 0 just before and read
    just after, and the calls of ``ChunkLayout.mask_tail`` counted (on the
    card the query kernel writes the padded tail's +0.0 itself). Returns
    ``{"seconds", "counts", "losses" (the rounds' losses, concatenated),
    "mask_tail_calls"}``."""
    for _ in range(2):
        one_round(batch)
    _sync()
    masks = []
    mask_tail = ChunkLayout.mask_tail

    def counted_mask_tail(self, c3):
        masks.append(c3.device.type)
        return mask_tail(self, c3)

    with mock.patch.object(ChunkLayout, "mask_tail", counted_mask_tail):
        kernels.reset_launch_counts()
        t = time.perf_counter()
        losses = [one_round(batch)[0] for _ in range(n)]
        _sync()
        seconds = time.perf_counter() - t
        counts = kernels.launch_counts()
    return {"seconds": seconds, "counts": counts,
            "losses": np.concatenate([np.ravel(x) for x in losses]),
            "mask_tail_calls": len(masks)}


def build_offload(extra, num_clients: int, env: dict, state_dir: str,
                  base=OFFLOAD_BASE, prefetch: bool = True,
                  device: str = "cuda", tiny: bool = False):
    """FedModel / FedOptimizer / LambdaLR (constant lr 0.1) for the round
    of ``base`` plus ``extra`` at ``num_clients``, with the tier the plan
    resolves under ``env`` (the budget overrides; empty: the planner's own
    probes), the disk tier in ``state_dir`` and the cohort prefetcher on
    or off. ``tiny``: the JAX bench's CPU geometry."""
    env = dict(env, COMMEFFICIENT_COHORT_PREFETCH="1" if prefetch else "0")
    with env_vars(**env):
        args = parse_args(argv=on_device(base, device) + list(extra) + (
            TINY_SKETCH if tiny else []) + [
            "--num_clients", str(num_clients), "--state_dir", state_dir])
        model = ResNet9(channels=TINY_CHANNELS) if tiny else ResNet9()
        train_loss, val_loss = make_cv_losses(model)
        fm = FedModel(model, train_loss, args, val_loss,
                      num_clients=num_clients)
    opt = FedOptimizer(fm, args)
    sched = LambdaLR(opt, lambda step: 0.1)
    return args, fm, opt, sched


def engine_rounds(fm, opt, sched, batches, submit=None, offloads=None,
                  warmup: int = 0):
    """The batches through ``PipelinedRoundEngine(window=2,
    drain_every=8)`` and ``cohort_lookahead`` (the prefetcher's path),
    each by ``submit(engine, batch)`` (default ``engine.submit``); each
    round's ``offload`` record appended to ``offloads`` where it is a
    list. The clock starts after the first ``warmup`` rounds, drained,
    and a device sync, and stops after the last drain and a sync. Returns
    ``(the rounds' results, seconds of the rounds after the warm-up)``."""
    from commefficient_torch.federated.engine import (
        PipelinedRoundEngine,
        cohort_lookahead,
    )

    if offloads is not None:
        seal = fm.seal_round

        def recording_seal(h):
            h = seal(h)
            offloads.append(h.offload)
            return h

        fm.seal_round = recording_seal
    eng = PipelinedRoundEngine(fm, opt, sched, window=2, drain_every=8)
    submit = submit or (lambda e, b: e.submit(b))
    got = []
    try:
        t = time.perf_counter()
        for i, b in enumerate(cohort_lookahead(batches, fm)):
            if warmup and i == warmup:
                got.extend(eng.drain())
                _sync()
                t = time.perf_counter()
            got.extend(submit(eng, b))
        got.extend(eng.drain())
        _sync()
        seconds = time.perf_counter() - t
    finally:
        if offloads is not None:
            del fm.seal_round
    return got, seconds
