"""The federated round on one device: the port of
``commefficient_tpu/federated/rounds.py`` for the FetchSGD sketched round.

One round, in the JAX package's order:

1. fused-gradient client phase: every client in the round holds the same
   weights and nothing nonlinear touches a per-client gradient, so the sum
   of per-client transmits is the gradient of the slot-masked sum of
   per-client losses; one backward over that sum (per microbatch);
2. weight decay ``(wd / num_workers) * sum(mask * count) * w``, added to
   the summed gradient BEFORE the sketch;
3. one sketch of the sum (sketch-after-sum);
4. the data-weighted division of the table by ``max(sum(mask), 1)``;
5. the server phase (``server.server_update``) and ``ps -= lr * update``.

PS weights stay resident in the sketch's ``(T, S, 128)`` chunk layout
(zero tail); the model sees them through ``ops/flat.ParamLayout`` views of
the unchunked vector, so the backward pass lands the gradient in that
layout directly.

Per-client state (local momentum/error), the per-client worker path,
guards, telemetry, the engine and sharding are later slices (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from commefficient_torch.federated.server import (
    ServerConfig,
    ServerState,
    server_update,
)
from commefficient_torch.federated.worker import (
    WorkerConfig,
    forward_metrics,
    microbatch_plan,
    split_microbatches,
)
from commefficient_torch.ops.flat import ChunkLayout, ParamLayout
from commefficient_torch.ops.sketch import CountSketch, sketch_chunks


@dataclass(frozen=True)
class RoundConfig:
    worker: WorkerConfig
    server: ServerConfig
    grad_size: int


class FederatedSteps(NamedTuple):
    client_step: Callable
    server_step: Callable
    val_step: Callable
    layout: ChunkLayout


def check_round_config(wcfg: WorkerConfig) -> None:
    """Raise for configs outside this slice: it runs only the fused
    sketch-after-sum client phase."""
    if wcfg.mode != "sketch":
        raise NotImplementedError(
            f"--mode {wcfg.mode} is not ported yet (ROADMAP.md, queue 1: the "
            "other server modes)")
    if (wcfg.has_velocity or wcfg.has_error
            or wcfg.max_grad_norm is not None):
        raise NotImplementedError(
            "per-client sketch-space state and clipping need the "
            "per-client worker path, which is not ported yet "
            "(ROADMAP.md, queue 1); use --error_type virtual "
            "--local_momentum 0")


def build_round_step(compute_loss_train: Callable,
                     compute_loss_val: Callable, params: ParamLayout,
                     cfg: RoundConfig, sketch: CountSketch) -> FederatedSteps:
    wcfg, scfg = cfg.worker, cfg.server
    check_round_config(wcfg)
    assert params.d == cfg.grad_size == sketch.d, \
        (params.d, cfg.grad_size, sketch.d)
    layout = sketch.chunk_layout

    def fused_clients(ps3, model_state, batch, worker_mask):
        """One-gradient client phase. Returns (summed gradient incl. weight
        decay in the chunk layout, per-client metrics)."""
        W, B = batch["mask"].shape
        mb, n_iters, pad = microbatch_plan(B, wcfg.microbatch_size)
        stacked = split_microbatches(batch, mb, n_iters, pad, example_dim=1)
        w = ps3.detach().requires_grad_(True)
        p = params.params(layout.unchunk(w))

        def per_client(b):
            loss_sum, msums, count, _ = compute_loss_train(
                p, model_state, b, None, True)
            return loss_sum, msums, count

        g_sum = torch.zeros_like(ps3)
        loss_sums = torch.zeros(W, device=ps3.device)
        counts = torch.zeros(W, device=ps3.device)
        m_sums = None
        for it in range(n_iters):
            micro = {k: v[it] for k, v in stacked.items()}
            ls, ms, cs = vmap(per_client)(micro)
            total = torch.sum(ls * worker_mask)
            (g,) = torch.autograd.grad(total, w)
            g_sum = g_sum + g
            loss_sums = loss_sums + ls.detach()
            ms = tuple(m.detach() for m in ms)
            m_sums = ms if m_sums is None else tuple(
                a + m for a, m in zip(m_sums, ms))
            counts = counts + cs.detach()
        if wcfg.weight_decay != 0:
            wd_scale = torch.sum(worker_mask * counts)
            g_sum = g_sum + ((wcfg.weight_decay / wcfg.num_workers)
                             * wd_scale) * ps3
        denom = torch.clamp(counts, min=1.0)
        metrics = (loss_sums / denom,) + tuple(m / denom for m in m_sums) \
            + (counts,)
        return g_sum, metrics

    def client_step(ps3, model_state, batch):
        """Phase 1: the round's data-weighted ``(r, c_pad)`` sketch table
        (the server phase's input), the model state, per-client metrics."""
        worker_mask = batch["worker_mask"]
        data = {k: v for k, v in batch.items()
                if k not in ("client_ids", "worker_mask")}
        g_sum, metrics = fused_clients(ps3, model_state, data, worker_mask)
        table = sketch_chunks(sketch, g_sum)
        total_count = torch.clamp(batch["mask"].sum(), min=1.0)
        return table / total_count, model_state, metrics

    def server_step(ps3, server_state: ServerState, table, lr):
        """Phase 2: server rule and the weight update."""
        update, new_state = server_update(table, server_state, scfg, lr,
                                          sketch=sketch, layout=layout)
        return ps3 - update, new_state

    def val_step(ps3, model_state, batch):
        w = layout.unchunk(ps3) if ps3.ndim != 1 else ps3
        return forward_metrics(compute_loss_val, params.params(w),
                               model_state, batch)

    return FederatedSteps(client_step=client_step, server_step=server_step,
                          val_step=val_step, layout=layout)

