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

``--stream_sketch`` (``RoundConfig.stream_sketch``) swaps steps 1-3 for
the streaming client phase (``fused_clients_stream``): the backward pass
differentiates with respect to each parameter leaf, the leaf gradients are
sketched at their flat offsets into a running ``(r, c_pad)`` table after
each microbatch (one launch per group of adjacent leaves under
``--sketch_coalesce``), weight decay goes in as one more full-range
accumulate after the microbatch loop, and no d-sized gradient exists.

Per-client state (local momentum/error), the per-client worker path,
guards, telemetry, the engine and sharding are later slices (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

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
    sketch_grad_tree,
    split_microbatches,
)
from commefficient_torch.ops.flat import (
    ChunkLayout,
    LeafSegment,
    ParamLayout,
    SegmentGroup,
    chunked_unravel,
    coalesce_segments,
    jax_to_torch_layout,
    leaf_segments,
)
from commefficient_torch.ops.sketch import (
    CountSketch,
    coalesce_vmem_budget,
    sketch_chunks,
    sketch_chunks_accum,
)


@dataclass(frozen=True)
class RoundConfig:
    worker: WorkerConfig
    server: ServerConfig
    grad_size: int
    # the streaming client phase (--stream_sketch)
    stream_sketch: bool = False
    # one accumulate launch per group of adjacent leaves (--sketch_coalesce;
    # only inside the streaming client phase)
    sketch_coalesce: bool = False


class FederatedSteps(NamedTuple):
    client_step: Callable
    server_step: Callable
    val_step: Callable
    layout: ChunkLayout
    # the streaming client phase's leaf layout and group plan (None when
    # the round is composed, or streams leaf by leaf)
    stream_segments: Optional[Tuple[LeafSegment, ...]] = None
    stream_groups: Optional[Tuple[SegmentGroup, ...]] = None


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
    stream_segs = stream_unravel = stream_groups = None
    if cfg.stream_sketch:
        stream_segs = leaf_segments(params)
        assert stream_segs[-1].offset + stream_segs[-1].size == \
            cfg.grad_size, "leaf layout does not cover the flat vector"
        stream_unravel = chunked_unravel(layout, params)
        if cfg.sketch_coalesce:
            stream_groups = coalesce_segments(
                stream_segs, coalesce_vmem_budget(sketch),
                chunk_elems=sketch.c_pad)

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

    def fused_clients_stream(ps3, model_state, batch, worker_mask):
        """Streaming client phase: like ``fused_clients``, but the
        microbatch loop carries the ``(r, c_pad)`` table instead of a
        d-sized gradient. The backward pass differentiates with respect to
        the parameter leaves; after ``torch.autograd.grad`` returns, the
        leaf gradients are sketched in offset order (never from backward
        hooks, which fire in reverse layer order: the per-cell add order
        must be the composed fold's). Weight decay is one more full-range
        accumulate of the resident weights after the loop. Returns (the
        undivided table, per-client metrics).

        With one microbatch and no weight decay the table equals the
        composed ``sketch_chunks(g_sum)`` under ``==``; several microbatches
        or weight decay reorder float32 sums, as in the JAX package."""
        W, B = batch["mask"].shape
        mb, n_iters, pad = microbatch_plan(B, wcfg.microbatch_size)
        stacked = split_microbatches(batch, mb, n_iters, pad, example_dim=1)
        leaves = stream_unravel(ps3)
        p = {e.torch_name: jax_to_torch_layout(x)
             for e, x in zip(params.entries, leaves)}

        def per_client(b):
            loss_sum, msums, count, _ = compute_loss_train(
                p, model_state, b, None, True)
            return loss_sum, msums, count

        table = torch.zeros(sketch.table_shape, dtype=torch.float32,
                            device=ps3.device)
        loss_sums = torch.zeros(W, device=ps3.device)
        counts = torch.zeros(W, device=ps3.device)
        m_sums = None
        for it in range(n_iters):
            micro = {k: v[it] for k, v in stacked.items()}
            ls, ms, cs = vmap(per_client)(micro)
            total = torch.sum(ls * worker_mask)
            grads = torch.autograd.grad(total, leaves)
            table = sketch_grad_tree(sketch, table, grads, stream_segs,
                                     stream_groups)
            loss_sums = loss_sums + ls.detach()
            ms = tuple(m.detach() for m in ms)
            m_sums = ms if m_sums is None else tuple(
                a + m for a, m in zip(m_sums, ms))
            counts = counts + cs.detach()
        if wcfg.weight_decay != 0:
            wd_scale = torch.sum(worker_mask * counts)
            coef = (wcfg.weight_decay / wcfg.num_workers) * wd_scale
            table = sketch_chunks_accum(sketch, table, ps3 * coef)
        denom = torch.clamp(counts, min=1.0)
        metrics = (loss_sums / denom,) + tuple(m / denom for m in m_sums) \
            + (counts,)
        return table, metrics

    def client_step(ps3, model_state, batch):
        """Phase 1: the round's data-weighted ``(r, c_pad)`` sketch table
        (the server phase's input), the model state, per-client metrics."""
        worker_mask = batch["worker_mask"]
        data = {k: v for k, v in batch.items()
                if k not in ("client_ids", "worker_mask")}
        if cfg.stream_sketch:
            table, metrics = fused_clients_stream(ps3, model_state, data,
                                                  worker_mask)
        else:
            g_sum, metrics = fused_clients(ps3, model_state, data,
                                           worker_mask)
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
                          val_step=val_step, layout=layout,
                          stream_segments=stream_segs,
                          stream_groups=stream_groups)

