"""The tiny federated geometries the multi-process demo runs: the port's
copies of the JAX driver entry's ``run_tiny_sketched_round`` and
``run_tiny_engine`` (``__graft_entry__.py``), on the port's ``FedModel``.

- ``run_tiny_sketched_round``: one fused round of ResNet9 at 4/8/8/16
  channels, a 3 x 512 sketch (2 blocks, seed 0), k = 64, virtual momentum
  0.9, weight decay 5e-4, lr 0.01, on ``W`` slots of 2 seeded images
  (``mode`` ``sketch`` or ``uncompressed``, the latter with no error
  feedback), optionally ``--server_shard`` under a ``collective_plan``.
- ``run_tiny_engine``: ``FedModel`` / ``FedOptimizer`` / ``LambdaLR`` (a
  constant 0.5) and the round engine over ``rounds`` seeded rounds of the
  ``Dense(4)`` model on 3 inputs (a 2 x 16 sketch, k = 2), the server
  sharded over the whole grid; a run state saved after round ``save_at``
  (every rank takes part, rank 0 writes) and ``resume_path`` restored
  before the first round.

Both take the client group (``group``, a ``ClientGroup``; None: one
device) and the initial flat weights (``init``, in JAX ravel order; None:
the port's own seeded init), and return numpy arrays.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch

TINY_CHANNELS = (("prep", 4), ("layer1", 8), ("layer2", 8), ("layer3", 16))
ROUND_LR = 0.01
ENGINE_LR = 0.5


def _weights(fm) -> np.ndarray:
    w = (fm.layout.unchunk(fm.ps_weights) if fm.layout is not None
         else fm.ps_weights)
    return w.detach().cpu().numpy().copy()


def _args(argv, group, device):
    """The port's parsed args; ``--num_devices`` is the group's clients
    axis."""
    from commefficient_torch.config import parse_args

    n = group.axis_sizes["clients"] if group is not None else 1
    return parse_args(argv=list(argv) + [
        "--num_devices", str(n), "--seed", "0", "--no_telemetry",
        "--dataset_name", "CIFAR10", "--local_batch_size", "2",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--device", torch.device(device).type])


@contextlib.contextmanager
def one_rank_group(W: int, device="cpu", force_dcn: bool = False):
    """A gloo process group of this process alone and its client grid:
    the one-process reference of a multi-process run (``--server_shard``
    needs a group). ``force_dcn`` places its clients axis on ``dcn``
    (``COMMEFFICIENT_FORCE_DCN_AXIS=clients``), so that a plan's ``dcn``
    entries resolve as they do across nodes."""
    import torch.distributed as dist

    from commefficient_torch.parallel.mesh import make_client_group

    old = os.environ.get("COMMEFFICIENT_FORCE_DCN_AXIS")
    with tempfile.TemporaryDirectory(prefix="one_rank_") as tmp:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=0, world_size=1)
        try:
            if force_dcn:
                os.environ["COMMEFFICIENT_FORCE_DCN_AXIS"] = "clients"
            try:
                group = make_client_group(W, 1, torch.device(device))
            finally:
                if old is None:
                    os.environ.pop("COMMEFFICIENT_FORCE_DCN_AXIS", None)
                else:
                    os.environ["COMMEFFICIENT_FORCE_DCN_AXIS"] = old
            yield group
        finally:
            dist.destroy_process_group()


def tiny_round_batch(W: int, B: int = 2) -> dict:
    """The round's inputs, as the JAX helper draws them."""
    rng = np.random.RandomState(0)
    return {
        "inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
        "targets": rng.randint(0, 10, (W, B)),
        "mask": np.ones((W, B), np.float32),
        "client_ids": np.arange(W, dtype=np.int32),
        "worker_mask": np.ones(W, np.float32),
    }


def run_tiny_sketched_round(W: int, mode: str = "sketch",
                            server_shard: bool = False,
                            collective_plan: str = "",
                            reduce_dtype: str = "float32",
                            group=None, device="cpu",
                            init: Optional[np.ndarray] = None):
    """One round of the tiny flagship geometry: ``(new_ps, flat0)``."""
    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated.losses import make_cv_losses
    from commefficient_torch.models import ResNet9
    from commefficient_torch.ops.flat import ParamLayout

    et = "virtual" if mode == "sketch" else "none"
    argv = ["--mode", mode, "--error_type", et, "--k", "64",
            "--num_cols", "512", "--num_rows", "3", "--num_blocks", "2",
            "--weight_decay", "5e-4", "--num_workers", str(W),
            "--num_clients", str(2 * W), "--reduce_dtype", reduce_dtype]
    if server_shard:
        argv.append("--server_shard")
    if collective_plan:
        argv += ["--collective_plan", collective_plan]
    args = _args(argv, group, device)
    model = ResNet9(channels=TINY_CHANNELS)
    train, val = make_cv_losses(model)
    fm = FedModel(model, train, args, val, num_clients=2 * W,
                  init_params=(None if init is None else flat_from_jax(
                      init, ParamLayout(model), device)),
                  device=device, group=group)
    try:
        flat0 = _weights(fm)
        opt = FedOptimizer(fm, args)
        opt.set_lr_factor(ROUND_LR)
        fm(tiny_round_batch(W))
        opt.step()
        return _weights(fm), flat0
    finally:
        fm.finalize()


def tiny_engine_batch(W: int, round_no: int) -> dict:
    """Round ``round_no``'s batch, as the JAX helper draws it: seeded by
    the round, the cohorts alternating between rows ``[0, W)`` and ``[W,
    2W)``."""
    rng = np.random.RandomState(100 + round_no)
    return {
        "inputs": rng.randn(W, 2, 3).astype(np.float32),
        "targets": rng.randn(W, 2, 4).astype(np.float32),
        "mask": np.ones((W, 2), np.float32),
        "client_ids": np.arange(W, dtype=np.int32) + (round_no % 2) * W,
        "worker_mask": np.ones(W, np.float32),
    }


class TinyDense(torch.nn.Module):
    """The JAX helper's ``nn.Dense(4, use_bias=False)`` on 3 inputs: one
    ``Dense_0/kernel`` leaf."""

    def __init__(self):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.zeros(4, 3))
        torch.nn.init.normal_(self.kernel, std=3 ** -0.5)

    def jax_param_path(self, name):
        return ("Dense_0", "kernel")

    def jax_param_kind(self, name):
        return "dense"

    def initial_model_state(self):
        return {}


def tiny_dense_loss(params, model_state, batch, rng, train):
    """The JAX helper's loss: the masked sum of the mean squared error."""
    pred = batch["inputs"] @ params["kernel"].T
    err = pred - batch["targets"]
    mask = batch["mask"]
    return torch.sum(torch.square(err).mean(-1) * mask), (), \
        torch.sum(mask), model_state


def run_tiny_engine(W: int, rounds: int = 4, shard_devices: int = 1,
                    mode: str = "sketch", collective_plan: str = "",
                    reduce_dtype: str = "float32",
                    save_path: Optional[str] = None,
                    save_at: Optional[int] = None,
                    resume_path: Optional[str] = None, window: int = 2,
                    group=None, device="cpu",
                    init: Optional[np.ndarray] = None):
    """The engine path of the tiny geometry: ``(weights, ckpt_path)``,
    the final weights and the run state written (None unless saved)."""
    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.federated import (
        FedModel,
        FedOptimizer,
        LambdaLR,
        PipelinedRoundEngine,
    )
    from commefficient_torch.federated.checkpoint import (
        load_run_state,
        save_run_state,
    )
    from commefficient_torch.ops.flat import ParamLayout

    et = "virtual" if mode == "sketch" else "none"
    argv = ["--mode", mode, "--error_type", et, "--k", "2",
            "--num_workers", str(W), "--weight_decay", "0",
            "--num_clients", str(2 * W), "--num_epochs", str(rounds),
            "--num_cols", "16", "--num_rows", "2", "--num_blocks", "1",
            "--server_shard", "--shard_devices", str(shard_devices),
            "--reduce_dtype", reduce_dtype]
    if collective_plan:
        argv += ["--collective_plan", collective_plan]
    args = _args(argv, group, device)
    torch.manual_seed(0)
    model = TinyDense()
    fm = FedModel(model, tiny_dense_loss, args, num_clients=2 * W,
                  init_params=(None if init is None else flat_from_jax(
                      init, ParamLayout(model), device)),
                  device=device, group=group)
    opt = FedOptimizer(fm, args)
    sched = LambdaLR(opt, lambda step: ENGINE_LR)
    start = 0
    if resume_path:
        start, _, _ = load_run_state(resume_path, fm, opt, sched)
    ckpt_path = None
    eng = PipelinedRoundEngine(fm, opt, lr_scheduler=sched, window=window)
    try:
        for r in range(start, rounds):
            eng.submit(tiny_engine_batch(W, r))
            if save_path and save_at is not None and r + 1 == save_at:
                eng.drain()
                ckpt_path = save_run_state(save_path, fm, opt, sched,
                                           next_epoch=r + 1)
        eng.drain()
    finally:
        eng.close()
        fm.finalize()
    return _weights(fm), ckpt_path
