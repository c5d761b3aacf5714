"""Client-side (worker) computation: the port of
``commefficient_tpu/federated/worker.py``, one client per call.

Semantics preserved:

- per-example-mean gradient x local batch size, so the cross-client sum is
  data-weighted; weight decay folded in as ``wd / num_workers x weights``;
- local momentum ``v = g + m v`` on the client's state row; local error
  ``e += v``, transmit ``e``;
- local_topk: transmit the top-k, zero error and velocity at the
  transmitted coordinates;
- sketch mode transmits the count-sketch table of the weighted gradient;
  local momentum and local error are carried in sketch space (``(r,
  c_pad)`` rows: sketches are linear, so the recurrences commute with
  sketching);
- DP: clip to ``l2_norm_clip``, then add ``N(0, noise_multiplier^2) x
  sqrt(num_workers)`` noise in worker mode, drawn from an explicit
  ``torch.Generator``;
- ``max_grad_norm``: a dense clip, except in sketch mode, where the table
  is clipped by its ``l2estimate``;
- fedavg: ``num_fedavg_epochs`` of local SGD over ``fedavg_batch_size``
  chunks with per-step decay, transmitting ``(w0 - w_final) x count``;
- microbatched gradient accumulation (the exact per-example mean);
- under GPT-2's sequence parallelism (``seq_group``, the rank's ``seq``
  axis) each rank's gradient is its slice of the sequence's part, summed
  over the axis before weight decay (and, in fedavg, before each local
  step), so every seq rank holds the client's whole gradient;
- under tensor and expert parallelism (``model_group`` / ``expert_group``)
  each rank's gradient is its slice's on the sliced leaves and whole on
  the rest: after the seq sum it is summed over ``model`` and multiplied
  by ``tp_scale``, then summed over ``expert`` and multiplied by
  ``ep_scale`` (the flat masks of ``federated/rounds.py``: 1 on the
  sliced leaves, 1/n on the replicated rest); under the pipeline
  (``stage_group``) each stage's gradient holds its layers' part alone,
  summed over ``stage`` at scale 1 between the model and the expert sums:
  the JAX package's chain (``reconcile``).

The loss callback contract is ``compute_loss(param_views, model_state,
microbatch, rng, train) -> (loss_sum, metric_sums, count,
new_model_state)``. The worker functions take the flat ``(d,)`` weights
(JAX ravel order) and ``params``, the model's ``ops/flat.ParamLayout``: a
gradient is taken with respect to each parameter leaf and laid out flat
in that order (``ParamLayout.leaves`` / ``gather_grads``), as the
fused-gradient client phase of ``federated/rounds.py`` does. That phase
shares ``microbatch_plan``, ``split_microbatches`` and
``sketch_grad_tree`` with this module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from commefficient_torch.ops.clip import clip_by_l2
from commefficient_torch.ops.collectives import all_reduce_sum
from commefficient_torch.ops.flat import LeafSegment, ParamLayout, SegmentGroup
from commefficient_torch.ops.sketch import (
    CountSketch,
    l2estimate,
    sketch_segment_accum,
    sketch_segments_accum,
    sketch_vec,
)
from commefficient_torch.ops.topk import topk


@dataclass(frozen=True)
class WorkerConfig:
    mode: str
    error_type: str = "none"
    k: int = 0
    num_workers: int = 1
    weight_decay: float = 0.0
    local_momentum: float = 0.0
    microbatch_size: int = -1
    max_grad_norm: Optional[float] = None
    do_dp: bool = False
    dp_mode: str = "worker"
    l2_norm_clip: float = 1.0
    noise_multiplier: float = 0.0
    num_fedavg_epochs: int = 1
    fedavg_batch_size: int = -1
    fedavg_lr_decay: float = 1.0
    do_topk_down: bool = False
    # the client group's seq, model, stage and expert axes under sequence,
    # tensor, pipeline and expert parallelism (taken from the realized
    # grid), else None
    seq_axis: Optional[str] = None
    model_axis: Optional[str] = None
    expert_axis: Optional[str] = None
    pp_axis: Optional[str] = None

    @property
    def has_velocity(self) -> bool:
        # client velocities exist iff local_momentum > 0
        return self.local_momentum > 0

    @property
    def has_error(self) -> bool:
        # client errors exist iff error_type == "local"
        return self.error_type == "local"


class ClientResult(NamedTuple):
    transmit: torch.Tensor  # (d,) dense or (r, c_pad) table, x count
    new_velocity: Optional[torch.Tensor]
    new_error: Optional[torch.Tensor]
    metrics: Tuple[torch.Tensor, ...]  # (loss_mean, *metric_means, count)


def microbatch_plan(B: int, microbatch_size: int):
    """``(mb, n_iters, pad)`` for splitting a B-example batch into equal
    microbatch slices (<= 0 means whole-batch)."""
    mb = B if microbatch_size <= 0 else min(microbatch_size, B)
    n_iters = -(-B // mb)
    return mb, n_iters, n_iters * mb - B


def split_microbatches(batch: Dict[str, torch.Tensor], mb: int, n_iters: int,
                       pad: int, example_dim: int = 0):
    """Reshape every batch leaf's example axis into ``(n_iters, mb)``
    zero-padded microbatch slices, with the microbatch axis moved to the
    front."""
    def split(x):
        if pad:
            shape = list(x.shape)
            shape[example_dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim=example_dim)
        x = x.reshape(x.shape[:example_dim] + (n_iters, mb)
                      + x.shape[example_dim + 1:])
        return torch.movedim(x, example_dim, 0)

    return {k: split(v) for k, v in batch.items()}


def forward_metrics(compute_loss, params, model_state, batch):
    """The val path of ``forward_grad``: ``(loss_mean, *metric_means,
    count)`` over the masked batch, without a gradient."""
    with torch.no_grad():
        loss_sum, msums, count, _ = compute_loss(params, model_state, batch,
                                                 None, False)
    denom = torch.clamp(count, min=1.0)
    return (loss_sum / denom,) + tuple(m / denom for m in msums) + (count,)


def sketch_grad_tree(sketch: CountSketch, table: torch.Tensor,
                     grads: Sequence[torch.Tensor],
                     segments: Sequence[LeafSegment],
                     groups: Optional[Sequence[SegmentGroup]] = None,
                     scales: Optional[Sequence[float]] = None
                     ) -> torch.Tensor:
    """Stream leaf gradients into a running count-sketch table (the JAX
    package's ``sketch_grad_tree``): each leaf is accumulated at its flat
    offset (``ops/flat.leaf_segments``), so the d-vector is never formed.
    ``grads`` come in offset order (the JAX layout of each leaf), so per
    table cell the adds continue the composed path's chunk-ordered fold.
    With ``groups`` (an ``ops/flat.coalesce_segments`` plan) each group of
    adjacent leaves is one accumulate launch; without, one per leaf.
    ``scales`` (one float a leaf): the tensor and expert parallelism
    rescale of each leaf, multiplied in before it is sketched."""
    assert len(grads) == len(segments), (len(grads), len(segments))
    for g, seg in zip(grads, segments):
        assert g.numel() == seg.size, (tuple(g.shape), seg)
    if scales is not None:
        assert len(scales) == len(segments), (len(scales), len(segments))
        grads = [g if float(v) == 1.0 else g * float(v)
                 for g, v in zip(grads, scales)]
    if groups is None:
        for g, seg in zip(grads, segments):
            table = sketch_segment_accum(sketch, table, g, seg.offset)
        return table
    assert groups[0].start == 0 and groups[-1].stop == len(segments) \
        and all(a.stop == b.start for a, b in zip(groups[:-1], groups[1:])), \
        "groups must partition the leaf segments in order"
    for grp in groups:
        table = sketch_segments_accum(sketch, table,
                                      grads[grp.start:grp.stop], grp.offset)
    return table


def leaf_grads(loss: torch.Tensor, leaves):
    """The gradient of ``loss`` by each parameter leaf; a leaf the loss
    does not use gets zeros (a pipeline stage uses only its own layers,
    the embeddings or the heads)."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def _grad_of(compute_loss, params: ParamLayout, w_flat, model_state, batch,
             rng):
    """``(gradient of loss_sum by the flat weights, loss_sum, metric_sums,
    count, new_model_state)`` on one batch, all detached. The gradient is
    taken by leaf and laid out flat once (O(d)); through the views of one
    flat tensor each leaf's backward would fill and add a d-sized
    gradient."""
    leaves = params.leaves(w_flat)
    loss_sum, msums, count, new_state = compute_loss(
        params.params_of(leaves), model_state, batch, rng, True)
    g = params.gather_grads(leaf_grads(loss_sum, leaves),
                            torch.empty_like(w_flat))
    if isinstance(new_state, dict):
        new_state = {k: v.detach() for k, v in new_state.items()}
    return (g, loss_sum.detach(), tuple(m.detach() for m in msums),
            count.detach(), new_state)


def _microbatch_grads(compute_loss, params_flat, params, model_state, batch,
                      rng, cfg: WorkerConfig):
    """Per-example-mean flat gradient over the masked batch, accumulated
    over microbatches. Returns ``(grad_mean, loss_mean, metric_means,
    count, new_model_state)``."""
    B = batch["mask"].shape[0]
    mb, n_iters, pad = microbatch_plan(B, cfg.microbatch_size)
    stacked = split_microbatches(batch, mb, n_iters, pad)
    zero = torch.zeros((), device=params_flat.device)
    g_sum = torch.zeros_like(params_flat)
    loss_sum, count, m_sums, mstate = zero, zero, None, model_state
    for it in range(n_iters):
        micro = {k: v[it] for k, v in stacked.items()}
        g, ls, ms, cnt, mstate = _grad_of(compute_loss, params, params_flat,
                                          mstate, micro, rng)
        g_sum = g_sum + g
        loss_sum = loss_sum + ls
        m_sums = ms if m_sums is None else tuple(
            a + m for a, m in zip(m_sums, ms))
        count = count + cnt
    denom = torch.clamp(count, min=1.0)
    return (g_sum / denom, loss_sum / denom, tuple(m / denom for m in m_sums),
            count, mstate)


def reconcile(g: torch.Tensor, seq_group=None, model_group=None,
              tp_scale=None, expert_group=None, ep_scale=None,
              stage_group=None) -> torch.Tensor:
    """A rank's gradient made whole, in the JAX package's order: summed
    over the seq axis (each rank's part of the sequence), then over the
    model axis times ``tp_scale``, then over the stage axis (each stage's
    layers' part), then over the expert axis times ``ep_scale``
    (slice-local leaves summed at scale 1, replicated ones at 1/n). A
    group that is None is skipped."""
    if seq_group is not None:
        g = all_reduce_sum(g, seq_group)
    if model_group is not None:
        g = all_reduce_sum(g, model_group) * tp_scale
    if stage_group is not None:
        g = all_reduce_sum(g, stage_group)
    if expert_group is not None:
        g = all_reduce_sum(g, expert_group) * ep_scale
    return g


def forward_grad(compute_loss, params_flat, params, model_state, batch,
                 rng, cfg: WorkerConfig, sketch: Optional[CountSketch],
                 seq_group=None, model_group=None, tp_scale=None,
                 expert_group=None, ep_scale=None, stage_group=None):
    """One client's gradient and its transforms, in the JAX package's
    order: the sums over the seq, model, stage and expert axes
    (``reconcile``),
    weight decay, the dense ``max_grad_norm`` clip (not in sketch mode),
    DP (clip, then worker noise), then in sketch mode the table and its
    clip by ``l2estimate``. Returns ``(transmit, (loss_mean,
    *metric_means, count), new_model_state, dense_grad)``."""
    grad, loss_mean, metric_means, count, new_state = _microbatch_grads(
        compute_loss, params_flat, params, model_state, batch, rng, cfg)
    grad = reconcile(grad, seq_group, model_group, tp_scale, expert_group,
                     ep_scale, stage_group)
    if cfg.weight_decay != 0:
        grad = grad + (cfg.weight_decay / cfg.num_workers) * params_flat
    if cfg.max_grad_norm is not None and cfg.mode != "sketch":
        grad = clip_by_l2(grad, cfg.max_grad_norm)
    if cfg.do_dp:
        grad = clip_by_l2(grad, cfg.l2_norm_clip)
        if cfg.dp_mode == "worker":
            noise = cfg.noise_multiplier * torch.randn(
                grad.shape, generator=rng, dtype=grad.dtype,
                device=grad.device) * math.sqrt(float(cfg.num_workers))
            grad = grad + noise
    if cfg.mode == "sketch":
        g = sketch_vec(sketch, grad)
        if cfg.max_grad_norm is not None:
            g = clip_by_l2(g, cfg.max_grad_norm, norm=l2estimate(g))
    else:
        g = grad
    return g, (loss_mean,) + metric_means + (count,), new_state, grad


def local_step(compute_loss, params_flat, params, model_state, velocity,
               error, batch, rng, cfg: WorkerConfig,
               sketch: Optional[CountSketch],
               seq_group=None, **axes) -> Tuple[ClientResult, Any]:
    """One client's training contribution: ``forward_grad``, the ``x
    count`` scaling, local momentum and error, and the local top-k.
    ``axes``: ``forward_grad``'s model and expert groups and scales."""
    g, metrics, new_state, _ = forward_grad(
        compute_loss, params_flat, params, model_state, batch, rng, cfg,
        sketch, seq_group=seq_group, **axes)
    count = metrics[-1]
    # sum-of-example-gradients scaling; linear, so it applies to tables too
    g = g * count

    new_velocity, new_error = velocity, error
    if cfg.has_velocity:
        new_velocity = g + cfg.local_momentum * velocity
        carrier = new_velocity
    else:
        carrier = g
    if cfg.has_error:
        new_error = error + carrier
        to_transmit = new_error
    else:
        to_transmit = carrier

    if cfg.mode == "local_topk":
        to_transmit = topk(to_transmit, cfg.k)
        nz = to_transmit != 0
        zero = torch.zeros((), dtype=to_transmit.dtype,
                           device=to_transmit.device)
        if cfg.has_error:
            new_error = torch.where(nz, zero, new_error)
        if cfg.has_velocity:
            new_velocity = torch.where(nz, zero, new_velocity)

    return ClientResult(to_transmit, new_velocity, new_error,
                        metrics), new_state


def fedavg_local(compute_loss, params_flat, params, model_state, batch, rng,
                 lr, cfg: WorkerConfig,
                 seq_group=None, **axes) -> Tuple[ClientResult, Any]:
    """FedAvg local training: ``num_fedavg_epochs`` passes of local SGD
    over the client's batch in ``fedavg_batch_size`` chunks, the step
    decayed by ``fedavg_lr_decay ** step``; all-padding chunks are
    skipped (they move neither the weights nor the step count). Each
    step's gradient is made whole over the seq, model, stage and expert
    axes first (``reconcile``; ``axes``: its model, stage and expert
    groups and scales), so the local weights stay replicated. Transmits ``(w0 -
    w_final) x count``."""
    B = batch["mask"].shape[0]
    fbs, n_chunks, pad = microbatch_plan(B, cfg.fedavg_batch_size)
    chunks = split_microbatches(batch, fbs, n_chunks, pad)
    zero = torch.zeros((), device=params_flat.device)
    w, mstate = params_flat, model_state
    step = loss_acc = n_steps = zero
    m_acc = None
    for _ in range(cfg.num_fedavg_epochs):
        for i in range(n_chunks):
            chunk = {k: v[i] for k, v in chunks.items()}
            g, loss_sum, msums, count, mstate = _grad_of(
                compute_loss, params, w, mstate, chunk, rng)
            g = reconcile(g, seq_group, **axes)
            g_mean = g / torch.clamp(count, min=1.0)
            decay = cfg.fedavg_lr_decay ** step
            valid = (count > 0).to(torch.float32)
            w = w - valid * g_mean * lr * decay
            denom = torch.clamp(count, min=1.0)
            ms = tuple(valid * m / denom for m in msums)
            m_acc = ms if m_acc is None else tuple(
                a + m for a, m in zip(m_acc, ms))
            step = step + valid
            loss_acc = loss_acc + valid * loss_sum / denom
            n_steps = n_steps + valid
    count = batch["mask"].sum()
    # weight the delta by the client's dataset size
    transmit = (params_flat - w) * count
    denom = torch.clamp(n_steps, min=1.0)
    metrics = (loss_acc / denom,) + tuple(m / denom for m in m_acc) \
        + (count,)
    return ClientResult(transmit, None, None, metrics), mstate


def get_new_worker_weights(ps_weights, worker_weights, k: int,
                           do_topk_down: bool):
    """topk-down stale-weight reconstruction: the client moves toward the
    server's weights by the top-k of the difference (or all of it)."""
    diff = ps_weights - worker_weights
    update = topk(diff, k) if do_topk_down else diff
    return worker_weights + update
