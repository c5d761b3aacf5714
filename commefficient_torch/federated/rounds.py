"""The federated round on one device or over a client group: the port
of ``commefficient_tpu/federated/rounds.py``.

One round, in the JAX package's order:

1. the client phase (``client_step``): the gathered client-state rows, the
   per-client contributions, their sum, and the data-weighted division by
   ``max(sum(mask), 1)``;
2. the server phase (``server_step``): the server rule
   (``server.server_update``; fedavg's lr is applied on the clients, so the
   server sees lr = 1), ``ps -= update``, the masking of the per-client
   state rows and their delta scatter, and the topk-down stale-weight
   advance. Under ``--guards`` the whole transition is gated by the
   round's health verdict (``server.round_health``) with a select, so a
   poisoned round leaves weights, server state and client rows as they
   were; under ``--telemetry`` the round's metric vector
   (``telemetry.device_round_metrics``) is computed after the select.
   Both are returned after the state, verdict first, and both stay on the
   device.

The client phase takes one of two forms, decided as the JAX package
decides them:

- the fused-gradient phase (``fused_grad``: ``uncompressed``,
  ``true_topk`` and ``sketch`` with no local velocity or error, no DP, no
  topk-down, no ``max_grad_norm`` and no ``--test``): every client holds
  the same weights and nothing nonlinear touches a per-client gradient, so
  the sum of per-client transmits is the gradient of the slot-masked sum
  of per-client losses; one backward over that sum (per microbatch), with
  weight decay ``(wd / num_workers) * sum(mask * count) * w`` added after;
- the per-client path: the W slots run the worker math
  (``worker.local_step``, ``worker.fedavg_local``) one after the other,
  each on its own state rows (``one_client``), and the transmits are
  summed.

In sketch mode with nothing nonlinear on a client's table
(``sketch_after_sum``) the clients transmit dense gradients and the sum
is sketched once. PS weights stay resident in the sketch's ``(T, S,
128)`` chunk layout (zero tail) in sketch mode without ``--topk_down``
(``chunked``); every other mode keeps a flat ``(d,)`` vector. The model
sees the weights through ``ops/flat.ParamLayout`` views of the flat
vector. Both client phases make each view its own autograd leaf
(``ParamLayout.leaves``) and lay the leaf gradients out flat once
(``gather_grads``).

A loss with dropout (GPT-2) draws its masks from the round's generator:
in the fused phase each client's masks for each microbatch are drawn
before the ``vmap`` (the loss's ``draw_rng``) and passed in batched; on
the per-client path the generator goes to the loss itself.

``--stream_sketch`` (``RoundConfig.stream_sketch``, legal in the fused
sketch-after-sum chunked window and silently composed elsewhere, as in
the JAX package) swaps the fused phase for the streaming one
(``fused_clients_stream``): the backward pass differentiates with respect
to each parameter leaf, the leaf gradients are sketched at their flat
offsets into a running ``(r, c_pad)`` table after each microbatch (one
launch per group of adjacent leaves under ``--sketch_coalesce``), weight
decay goes in as one more full-range accumulate after the microbatch
loop, and no d-sized gradient exists.

Per-client state (``init_client_states``) is ``(num_clients, d)`` rows,
or ``(num_clients, r, c_pad)`` tables in sketch mode, on the round's
device; when the memory plan puts it on the host or on disk
(``federated/host_state.py``), the round runs on a W-row proxy of it with
``client_ids := arange(W)``, unchanged.

The model state is ResNet9's BatchNorm running statistics under
``--batchnorm`` (empty otherwise): each client's loss returns its updated
statistics, computed from the round's state over its microbatches in
order, and the round's new state is their slot-masked average
(``average_model_state``), on both client-phase forms.

Over a client group (``group``, a ``parallel/mesh.ClientGroup``: one
process per GPU) every rank receives the whole round's batch and runs its
``W / n`` slots. Without ``server_shard`` the rank's transmit sum is
all-reduced before the ``/count`` division; with it the unreduced sum goes
to ``server.sharded_server_update``, which owns the reduce. On the 2-D
(clients x shard) grid the group is the server reduce tuple: rank ``p``
runs slots ``[p * W/N, (p + 1) * W/N)``, and a per-axis plan is resolved
against the grid's axes when the steps are built
(``ops/collectives.plan_lowering``). The model
state is the slot-weighted mean over the ranks (a rank whose slots are
all padding adds 0 to the numerator and the denominator). The per-client
path all-gathers the slots' new state rows and metrics, so every rank's
replicated client state stays identical. Every rank draws what the
single-rank round draws for each slot: the fused phase draws the dropout
masks of all W clients and takes its own, and the per-client path gives
each slot its own generator, seeded from the round generator's state
(``slot_generators``).

Under GPT-2's sequence parallelism (``WorkerConfig.seq_axis``: the
group's ``seq`` axis, ``ClientGroup.seq``) the seq ranks of one tuple
index run the same slots, each on its ``T / n`` slice of the batch leaves
named in ``RoundConfig.seq_sharded_keys`` (cut on their last axis; the
other leaves are whole on every rank). A rank's gradient is its slice's
part, so the fused phase sums its gradient (or, streaming, its table)
over the seq axis before weight decay, as the JAX package does, and the
per-client worker sums each client's gradient over it
(``worker.forward_grad``, ``worker.fedavg_local``). From there on the
seq ranks hold the same values and run the same server step.

Under tensor and expert parallelism (``WorkerConfig.model_axis`` /
``expert_axis``: the group's ``model`` and ``expert`` axes) the ranks of
one tuple index run the same slots on the whole batch; each computes its
slice of the model (heads and MLP columns, or experts), so its gradient
is slice-local on the sliced leaves and whole on the rest. The round
reconciles it as the JAX package does: after the seq sum, a sum over
``model`` times ``tp_scale``, then a sum over ``expert`` times
``ep_scale``, then weight decay. The two flat masks are built once, on
the group's device, from the flat layout's leaf segments
(``ops/flat.leaf_segments``): 1 on the leaves the predicate
(``RoundConfig.tp_sliced`` / ``ep_sliced``: ``models/gpt2.
tp_sliced_param``, ``parallel/moe.ep_sliced_param``) names, 1/n on the
rest; the fused phase holds them in the resident layout, the per-client
worker flat. The streaming phase never makes them: it multiplies each
leaf by its product of the two values before sketching and sums the
table over the axes (exact for power-of-two axes).

Under the pipeline (``WorkerConfig.pp_axis``: the group's ``stage`` axis,
``parallel/pipeline.py``) the stage ranks of one tuple index run the same
slots on the whole batch, each through its own range of layers, so its
gradient is its layers' part (zero elsewhere); the round sums it over
``stage`` at scale 1, after the model sum and before the expert sum, in
every client phase (the streaming phase sums its table over the axis).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace as dc_replace
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from commefficient_torch.federated.server import (
    ServerConfig,
    ServerState,
    round_health,
    server_update,
    sharded_server_update,
)
from commefficient_torch.ops.collectives import (
    CollectivePlan,
    all_gather_tiled,
    all_reduce_sum,
    plan_lowering,
)
from commefficient_torch.federated.worker import (
    WorkerConfig,
    fedavg_local,
    forward_metrics,
    get_new_worker_weights,
    leaf_grads,
    local_step,
    microbatch_plan,
    reconcile,
    sketch_grad_tree,
    split_microbatches,
)
from commefficient_torch.ops.flat import (
    ChunkLayout,
    LeafSegment,
    ParamLayout,
    SegmentGroup,
    coalesce_segments,
    leaf_segments,
)
from commefficient_torch.ops.sketch import (
    CountSketch,
    coalesce_vmem_budget,
    sketch_chunks,
    sketch_chunks_accum,
    sketch_vec,
)
from commefficient_torch.telemetry import device_round_metrics


class ClientStates(NamedTuple):
    """Per-client persistent state; a member is None when the config does
    not need it. In sketch mode velocity and error are ``(num_clients, r,
    c_pad)`` tables, else ``(num_clients, d)`` rows."""

    velocities: Optional[torch.Tensor]
    errors: Optional[torch.Tensor]
    weights: Optional[torch.Tensor]  # (num_clients, d) iff do_topk_down


def _broadcast_state(model_state, W: int):
    """The round's model state as W per-client copies (a leading W axis,
    expanded views)."""
    return {k: v.expand((W,) + tuple(v.shape)) for k, v in
            model_state.items()}


def average_model_state(new_ms, model_state, worker_mask: torch.Tensor,
                        group=None):
    """The slot-masked cross-client average of the per-client model states
    (``new_ms``, a leading W axis), as the JAX package's round takes it
    (``commefficient_tpu/federated/rounds.py:847-869``): ``sum_c mask_c
    x_c / max(sum(mask), 1)``; an all-padding round keeps ``model_state``.
    An empty state (no BatchNorm) stays empty. Over a ``group`` the
    rank's slots are averaged, then the ranks' means weighted by their
    slot counts: ``sum_r w_r m_r / max(sum_r w_r, 1)``."""
    if not model_state:
        return model_state
    wsum = worker_mask.sum()
    denom = torch.clamp(wsum, min=1.0)
    local = {k: torch.einsum("c,c...->...", worker_mask, new_ms[k]) / denom
             for k in model_state}
    if group is not None:
        total_w = all_reduce_sum(wsum.clone(), group)
        tdenom = torch.clamp(total_w, min=1.0)
        local = {k: all_reduce_sum(v * wsum, group) / tdenom
                 for k, v in local.items()}
        wsum = total_w
    return {k: torch.where(wsum > 0, local[k], model_state[k])
            for k in model_state}


def slot_generators(rng: Optional[torch.Generator], W: int):
    """One generator for each of the round's W slots (the per-client
    path's worker DP noise and dropout, built only where a slot draws
    either), seeded from a hash of the round
    generator's state and the slot index, so a slot draws the same
    numbers on any rank of any group size; the round generator then moves
    on by one draw. Reading a generator's state and seeding one are
    host-only (no wait on the device). None without a round generator."""
    if rng is None:
        return [None] * W
    base = hashlib.sha256(rng.get_state().numpy().tobytes()).digest()
    gens = []
    for i in range(W):
        h = hashlib.sha256(base + i.to_bytes(8, "little")).digest()
        gens.append(torch.Generator(device=rng.device).manual_seed(
            int.from_bytes(h[:8], "little") >> 1))
    torch.rand(1, generator=rng, device=rng.device)
    return gens


class RoundContext(NamedTuple):
    """What the server phase needs from the client phase. ``*_rows`` are
    the participating clients' state rows before the round (None where the
    config keeps no such state), ``new_*`` after it."""

    gradient: torch.Tensor
    ids: torch.Tensor
    wmask: torch.Tensor  # (W,) 1 for participating slots, 0 for padding
    vel_rows: Optional[torch.Tensor]
    err_rows: Optional[torch.Tensor]
    stale_rows: Optional[torch.Tensor]
    new_vel: Optional[torch.Tensor]
    new_err: Optional[torch.Tensor]
    # the sharded server: gradient is this rank's unreduced sum and count
    # the round's data count (divided out after the reduce)
    count: Optional[torch.Tensor] = None


def init_client_states(num_clients: int, grad_size: int, wcfg: WorkerConfig,
                       init_weights: Optional[torch.Tensor] = None,
                       sketch: Optional[CountSketch] = None,
                       device=None) -> ClientStates:
    """Zero velocity and error rows where the config keeps them, and the
    topk-down stale weights as copies of ``init_weights`` (flat ``(d,)``),
    all on ``device`` (default ``cuda``). Dense rows cost ``num_clients x
    d x 4`` bytes an array."""
    device = torch.device(device if device is not None else "cuda")
    if wcfg.mode == "sketch" and (wcfg.has_velocity or wcfg.has_error):
        assert sketch is not None, \
            "sketch-mode client state needs the sketch geometry"
        state_shape = (num_clients,) + sketch.table_shape
    else:
        state_shape = (num_clients, grad_size)

    def alloc():
        if device.type == "cpu":
            # calloc semantics (the host tier): only the pages of rows a
            # round touches become resident
            return torch.from_numpy(np.zeros(state_shape, np.float32))
        return torch.zeros(state_shape, dtype=torch.float32, device=device)

    weights = None
    if wcfg.do_topk_down:
        assert init_weights is not None
        weights = init_weights.to(device=device, dtype=torch.float32)[
            None, :].repeat(num_clients, 1)
    return ClientStates(alloc() if wcfg.has_velocity else None,
                        alloc() if wcfg.has_error else None, weights)


@dataclass(frozen=True)
class RoundConfig:
    worker: WorkerConfig
    server: ServerConfig
    grad_size: int
    # --test: skip the forward and backward passes, transmit all ones
    do_test: bool = False
    # the streaming client phase (--stream_sketch)
    stream_sketch: bool = False
    # one accumulate launch per group of adjacent leaves (--sketch_coalesce;
    # only inside the streaming client phase)
    sketch_coalesce: bool = False
    # the sharded server over the client group (--server_shard) and the
    # wire dtype of each collective leg (--collective_plan; None: fp32)
    server_shard: bool = False
    collective_plan: Optional[CollectivePlan] = None
    # the health guard (--guards): server.round_health gates the whole
    # state transition, and server_step returns the verdict
    guards: bool = False
    # its magnitude ceiling (0 = finiteness only)
    guard_max_abs: float = 0.0
    # the metric vector (--telemetry; telemetry.device_round_metrics),
    # returned after the verdict; with its histograms (--telemetry_hist)
    telemetry: bool = False
    telemetry_hist: bool = False
    # the batch leaves whose last axis is the (globally ordered) sequence,
    # cut over the seq axis under sequence parallelism; every other leaf
    # is whole on each seq rank
    seq_sharded_keys: Tuple[str, ...] = ("input_ids", "token_type_ids",
                                         "lm_labels_shifted")
    # the leaves whose gradient a model (expert) rank computes for its
    # slice alone, by '/'-joined lowercase flax path; required when the
    # worker has a model (expert) axis
    tp_sliced: Optional[Callable[[str], bool]] = None
    ep_sliced: Optional[Callable[[str], bool]] = None


def slice_scale_values(segments, sliced: Callable[[str], bool], n: int
                       ) -> Tuple[float, ...]:
    """The rescale value of each leaf for an axis of ``n`` ranks: 1.0
    where ``sliced(path)`` (each rank's gradient is its slice's, and the
    sum over the axis is the whole), 1/n elsewhere (every rank computed
    the whole gradient)."""
    return tuple(1.0 if sliced(sg.path) else 1.0 / n for sg in segments)


def flat_scale(segments, values, device=None) -> torch.Tensor:
    """The flat ``(d,)`` float32 mask of per-leaf ``values`` over the
    leaf ``segments`` (``ops/flat.leaf_segments``)."""
    return torch.cat([torch.full((sg.size,), v, dtype=torch.float32,
                                 device=device)
                      for sg, v in zip(segments, values)])


def seq_slice(batch: dict, keys, seq_group) -> dict:
    """``batch`` with the leaves named in ``keys`` cut to this seq rank's
    slice of their last axis (the sequence, in rank order); no cut
    without a seq group."""
    if seq_group is None:
        return batch
    n, q = seq_group.size, seq_group.rank

    def cut(v):
        T = v.shape[-1]
        assert T % n == 0, f"sequence length {T} does not divide by {n}"
        return v[..., q * (T // n):(q + 1) * (T // n)].contiguous()

    return {k: cut(v) if k in keys else v for k, v in batch.items()}


class FederatedSteps(NamedTuple):
    """``server_step`` returns ``(weights, server state, client states)``,
    then the guard verdict under ``RoundConfig.guards`` and the metric
    vector under ``RoundConfig.telemetry``, in that order."""

    client_step: Callable
    server_step: Callable
    val_step: Callable
    # the chunk layout of the resident weights, None where they are flat
    layout: Optional[ChunkLayout]
    # the streaming client phase's leaf layout and group plan (None when
    # the round is composed, or streams leaf by leaf)
    stream_segments: Optional[Tuple[LeafSegment, ...]] = None
    stream_groups: Optional[Tuple[SegmentGroup, ...]] = None


def _select(ok, new, old):
    """``new`` where ``ok``, else ``old``: a tensor, None, or a tuple of
    per-level carries (None at float32 levels)."""
    if new is None:
        return None
    if isinstance(new, tuple):
        return tuple(_select(ok, a, b) for a, b in zip(new, old))
    return torch.where(ok, new, old)


def build_round_step(compute_loss_train: Callable,
                     compute_loss_val: Callable, params: ParamLayout,
                     cfg: RoundConfig,
                     sketch: Optional[CountSketch] = None,
                     group=None) -> FederatedSteps:
    """The round's steps; ``group`` (a ``ClientGroup``) splits the slots
    over ranks (None: the single-device round)."""
    wcfg, scfg = cfg.worker, cfg.server
    assert wcfg.mode == scfg.mode, (wcfg.mode, scfg.mode)
    server_shard = bool(cfg.server_shard)
    plan = cfg.collective_plan
    if server_shard:
        assert group is not None, \
            "--server_shard needs a client group (a process group)"
        assert not wcfg.do_topk_down, \
            "--server_shard is incompatible with --topk_down (stale-" \
            "weight math lives on dense client rows)"
    if plan is not None and plan.quantized:
        assert server_shard, \
            "quantized collective legs require --server_shard"
    # a per-axis plan's legs resolved on the grid (None: a flat plan)
    lowering = plan_lowering(plan, group) if server_shard else None
    assert params.d == cfg.grad_size, (params.d, cfg.grad_size)
    seq_group = stage_group = None
    if wcfg.seq_axis is not None:
        assert group is not None and group.seq is not None, \
            f"seq_axis {wcfg.seq_axis!r} not in the client group's axes"
        seq_group = group.axis(wcfg.seq_axis)
    if wcfg.pp_axis is not None:
        # the pipelined loss carries the GPipe schedule; the round only
        # sums the stages' disjoint gradient parts
        assert group is not None and group.stage is not None, \
            f"pp_axis {wcfg.pp_axis!r} not in the client group's axes"
        stage_group = group.axis(wcfg.pp_axis)
    if wcfg.mode == "sketch":
        assert sketch is not None and sketch.d == cfg.grad_size, \
            "sketch mode needs the sketch geometry of the flat vector"

    # chunked-resident weights: sketch mode without topk-down (its
    # stale-weight math lives on dense (num_clients, d) rows)
    chunked = wcfg.mode == "sketch" and not wcfg.do_topk_down
    layout = sketch.chunk_layout if chunked else None
    # sketch-after-sum: with nothing nonlinear on a client's table (no
    # sketch-space velocity, error or clip), the sum of per-client tables
    # is one table of the summed dense gradient; the clients then run the
    # dense worker math (mode "uncompressed") and the sum is sketched once
    sketch_after_sum = (wcfg.mode == "sketch" and not wcfg.has_velocity
                        and not wcfg.has_error
                        and wcfg.max_grad_norm is None and not cfg.do_test)
    inner_wcfg = (dc_replace(wcfg, mode="uncompressed") if sketch_after_sum
                  else wcfg)
    # fused-gradient client phase (see the module docstring)
    fused_grad = (
        not cfg.do_test
        and wcfg.mode in ("uncompressed", "true_topk", "sketch")
        and not wcfg.has_velocity and not wcfg.has_error
        and not wcfg.do_dp and not wcfg.do_topk_down
        and wcfg.max_grad_norm is None
    )
    # fused sketch mode only ever rides the sketch-after-sum path
    assert not (fused_grad and wcfg.mode == "sketch" and not sketch_after_sum)
    stream = bool(cfg.stream_sketch) and fused_grad and sketch_after_sum \
        and chunked

    # tensor and expert parallelism: the axis groups and their rescale
    # values per leaf (1 on slice-local leaves, 1/n on replicated ones)
    segs = leaf_segments(params)
    axis_groups, axis_vals = [], []
    for axis, pred, attr in ((wcfg.model_axis, cfg.tp_sliced, "tp_sliced"),
                             (wcfg.expert_axis, cfg.ep_sliced,
                              "ep_sliced")):
        if axis is None:
            axis_groups.append(None)
            axis_vals.append(None)
            continue
        assert group is not None, f"axis {axis!r} needs a client group"
        g = group.axis(axis)
        assert pred is not None, \
            f"worker axis {axis!r} set but RoundConfig.{attr} is missing"
        axis_groups.append(g)
        axis_vals.append(slice_scale_values(segs, pred, g.size))
    model_group, expert_group = axis_groups

    def scale_mask(vals):
        """The d-sized mask of per-leaf values, on the group's device, in
        the layout the client phase sums in."""
        if vals is None:
            return None
        m = flat_scale(segs, vals, group.device)
        assert m.numel() == cfg.grad_size, \
            "scale layout does not match the flat vector"
        return layout.chunk(m) if (chunked and fused_grad) else m

    stream_segs = stream_groups = stream_scales = None
    tp_scale = ep_scale = None
    if stream:
        stream_segs = segs
        assert stream_segs[-1].offset + stream_segs[-1].size == \
            cfg.grad_size, "leaf layout does not cover the flat vector"
        if cfg.sketch_coalesce:
            stream_groups = coalesce_segments(
                stream_segs, coalesce_vmem_budget(sketch),
                chunk_elems=sketch.c_pad)
        vals = [1.0] * len(segs)
        for v in axis_vals:
            if v is not None:
                vals = [a * b for a, b in zip(vals, v)]
        stream_scales = (tuple(vals) if any(v != 1.0 for v in vals)
                         else None)
    else:
        # the fused phase's masks in the resident layout, the per-client
        # worker's flat
        tp_scale, ep_scale = (scale_mask(v) for v in axis_vals)
    worker_axes = dict(model_group=model_group, tp_scale=tp_scale,
                       expert_group=expert_group, ep_scale=ep_scale,
                       stage_group=stage_group)

    def flat_res(w):
        """The resident weights (or a tensor in their layout) as a flat
        ``(d,)`` view: the chunked plane without its padded tail."""
        return layout.unchunk(w) if chunked else w

    draw_rng = getattr(compute_loss_train, "draw_rng", None)
    slot_draws = draw_rng is not None or (wcfg.do_dp
                                          and wcfg.dp_mode == "worker")

    def vmapped_losses(p, mstates, micro_full, rng, lo, hi):
        """Clients ``[lo, hi)``'s losses on one microbatch under ``vmap``
        (``micro_full`` holds all W). A loss that draws dropout masks
        (``draw_rng``) gets each client's own, drawn here for all W
        clients from the round's generator before the ``vmap`` and passed
        in as a batched input, so the masks differ per client and per
        microbatch, follow from the seed, and do not depend on the
        group's size."""
        def per_client(ms, b, keep):
            return compute_loss_train(p, ms, b, keep, True)

        micro = {k: v[lo:hi] for k, v in micro_full.items()}
        if draw_rng is None:
            return vmap(per_client, in_dims=(0, 0, None))(mstates, micro,
                                                          None)
        if rng is None:
            raise ValueError("this loss draws dropout masks; the fused "
                             "client phase needs the round's generator")
        return vmap(per_client)(mstates, micro,
                                draw_rng(rng, micro_full)[lo:hi])

    def fused_clients(ps, model_state, batch, worker_mask, rng, lo, hi):
        """One-gradient client phase over clients ``[lo, hi)`` of the
        round (``batch`` holds all W; ``worker_mask`` is this rank's).
        Returns (summed gradient incl. weight decay in the resident
        layout, the per-client model states stacked on a leading axis,
        per-client metrics). Each client's model state runs through its
        microbatches in order, from the round's state, as the JAX
        package's scan carries it."""
        B = batch["mask"].shape[1]
        W = hi - lo
        mb, n_iters, pad = microbatch_plan(B, wcfg.microbatch_size)
        stacked = split_microbatches(batch, mb, n_iters, pad, example_dim=1)
        # differentiate by leaf and lay the leaf gradients out once
        # (O(d)); through the views of one flat tensor each leaf's
        # backward would fill and add a d-sized gradient
        leaves = params.leaves(flat_res(ps))
        p = params.params_of(leaves)
        mstates = _broadcast_state(model_state, W)
        g_sum = torch.zeros_like(ps)
        loss_sums = torch.zeros(W, device=ps.device)
        counts = torch.zeros(W, device=ps.device)
        m_sums = None
        for it in range(n_iters):
            micro = {k: v[it] for k, v in stacked.items()}
            ls, ms, cs, mstates = vmapped_losses(p, mstates, micro, rng, lo,
                                                 hi)
            mstates = {k: v.detach() for k, v in mstates.items()}
            total = torch.sum(ls * worker_mask)
            g = torch.zeros_like(ps)
            params.gather_grads(leaf_grads(total, leaves),
                                flat_res(g))
            g_sum = g_sum + g
            loss_sums = loss_sums + ls.detach()
            ms = tuple(m.detach() for m in ms)
            m_sums = ms if m_sums is None else tuple(
                a + m for a, m in zip(m_sums, ms))
            counts = counts + cs.detach()
        # each seq rank backpropagated its slice of the sequence, each
        # model (expert) rank its slice of the model, each stage its layers
        # (linear: one sum of the sum replaces the per-client sums)
        g_sum = reconcile(g_sum, seq_group, **worker_axes)
        if wcfg.weight_decay != 0:
            wd_scale = torch.sum(worker_mask * counts)
            g_sum = g_sum + ((wcfg.weight_decay / wcfg.num_workers)
                             * wd_scale) * ps
        denom = torch.clamp(counts, min=1.0)
        metrics = (loss_sums / denom,) + tuple(m / denom for m in m_sums) \
            + (counts,)
        return g_sum, mstates, metrics

    def fused_clients_stream(ps3, model_state, batch, worker_mask, rng, lo,
                             hi):
        """Streaming client phase: like ``fused_clients``, but the
        microbatch loop carries the ``(r, c_pad)`` table instead of a
        d-sized gradient. The backward pass differentiates with respect to
        the parameter leaves; after ``torch.autograd.grad`` returns, the
        leaf gradients are sketched in offset order (never from backward
        hooks, which fire in reverse layer order: the per-cell add order
        must be the composed fold's). Weight decay is one more full-range
        accumulate of the resident weights after the loop. Returns (the
        undivided table, the per-client model states, per-client metrics).

        With one microbatch and no weight decay the table equals the
        composed ``sketch_chunks(g_sum)`` under ``==``; several microbatches
        or weight decay reorder float32 sums, as in the JAX package."""
        B = batch["mask"].shape[1]
        W = hi - lo
        mb, n_iters, pad = microbatch_plan(B, wcfg.microbatch_size)
        stacked = split_microbatches(batch, mb, n_iters, pad, example_dim=1)
        leaves = params.leaves(flat_res(ps3))
        p = params.params_of(leaves)
        mstates = _broadcast_state(model_state, W)
        table = torch.zeros(sketch.table_shape, dtype=torch.float32,
                            device=ps3.device)
        loss_sums = torch.zeros(W, device=ps3.device)
        counts = torch.zeros(W, device=ps3.device)
        m_sums = None
        for it in range(n_iters):
            micro = {k: v[it] for k, v in stacked.items()}
            ls, ms, cs, mstates = vmapped_losses(p, mstates, micro, rng, lo,
                                                 hi)
            mstates = {k: v.detach() for k, v in mstates.items()}
            total = torch.sum(ls * worker_mask)
            grads = leaf_grads(total, leaves)
            table = sketch_grad_tree(sketch, table, grads, stream_segs,
                                     stream_groups, stream_scales)
            loss_sums = loss_sums + ls.detach()
            ms = tuple(m.detach() for m in ms)
            m_sums = ms if m_sums is None else tuple(
                a + m for a, m in zip(m_sums, ms))
            counts = counts + cs.detach()
        # the fused phase's sums, riding the table (sketches are linear;
        # the rescales went in per leaf); weight decay goes in after them,
        # as there
        for g in (seq_group, model_group, stage_group, expert_group):
            if g is not None:
                table = all_reduce_sum(table, g)
        if wcfg.weight_decay != 0:
            wd_scale = torch.sum(worker_mask * counts)
            coef = (wcfg.weight_decay / wcfg.num_workers) * wd_scale
            table = sketch_chunks_accum(sketch, table, ps3 * coef)
        denom = torch.clamp(counts, min=1.0)
        metrics = (loss_sums / denom,) + tuple(m / denom for m in m_sums) \
            + (counts,)
        return table, mstates, metrics

    _probe = {}

    def one_client(ps_flat, vel_row, err_row, stale_row, model_state,
                   batch_row, lr, rng, slot_mask):
        """One slot of the per-client path. Returns (transmit x slot mask,
        new velocity row, new error row, new model state, metrics); a
        padded slot (mask 0) transmits zeros and keeps its rows (its model
        state is weighted 0 in the round's average)."""
        # the weights the client holds: the topk-down stale reconstruction
        weights_used = (get_new_worker_weights(ps_flat, stale_row, wcfg.k,
                                               True)
                        if wcfg.do_topk_down else ps_flat)
        if cfg.do_test:
            # smoke mode: no backward pass and an all-ones transmit; the
            # metrics (all ones, and the count) take the loss's arity,
            # learnt from one forward pass without a gradient
            shape = sketch.table_shape if wcfg.mode == "sketch" else \
                (cfg.grad_size,)
            transmit = torch.ones(shape, dtype=torch.float32,
                                  device=ps_flat.device)
            if "n_metrics" not in _probe:
                with torch.no_grad():
                    _probe["n_metrics"] = len(compute_loss_train(
                        params.params(weights_used), model_state, batch_row,
                        rng, True)[1])
            one = torch.ones((), device=ps_flat.device)
            metrics = (one,) * (1 + _probe["n_metrics"]) + \
                (batch_row["mask"].sum(),)
            new_vel, new_err, new_ms = vel_row, err_row, model_state
        elif wcfg.mode == "fedavg":
            res, new_ms = fedavg_local(compute_loss_train, weights_used,
                                       params, model_state,
                                       batch_row, rng, lr, wcfg,
                                       seq_group=seq_group, **worker_axes)
            transmit, new_vel, new_err, metrics = (res.transmit, vel_row,
                                                   err_row, res.metrics)
        else:
            res, new_ms = local_step(compute_loss_train, weights_used,
                                     params, model_state, vel_row,
                                     err_row, batch_row, rng, inner_wcfg,
                                     sketch, seq_group=seq_group,
                                     **worker_axes)
            transmit, new_vel, new_err, metrics = (
                res.transmit, res.new_velocity, res.new_error, res.metrics)
        transmit = transmit * slot_mask
        if new_vel is not None:
            new_vel = torch.where(slot_mask > 0, new_vel, vel_row)
        if new_err is not None:
            new_err = torch.where(slot_mask > 0, new_err, err_row)
        return transmit, new_vel, new_err, new_ms, metrics

    def per_client_path(ps, vel_rows, err_rows, stale_rows, model_state,
                        batch, lr, gens, worker_mask):
        """The per-client path: the slots one after the other, each
        through ``one_client`` with its own generator (``gens``); the
        transmits summed in slot order. The worker math runs on the flat
        vector, so a chunked round materializes the flat view once
        here."""
        ps_flat = layout.unchunk(ps) if chunked else ps
        total = None
        vels, errs, mss, metrics = [], [], [], []
        for i in range(worker_mask.shape[0]):
            t, nv, ne, nms, m = one_client(
                ps_flat, None if vel_rows is None else vel_rows[i],
                None if err_rows is None else err_rows[i],
                None if stale_rows is None else stale_rows[i], model_state,
                {k: v[i] for k, v in batch.items()}, lr, gens[i],
                worker_mask[i])
            total = t if total is None else total + t
            vels.append(nv)
            errs.append(ne)
            mss.append(nms)
            metrics.append(m)
        metrics = tuple(torch.stack([x.detach() for x in ms])
                        for ms in zip(*metrics))
        new_vel = None if vel_rows is None else torch.stack(vels)
        new_err = None if err_rows is None else torch.stack(errs)
        new_ms = {k: torch.stack([m[k].detach() for m in mss])
                  for k in model_state}
        return total, new_vel, new_err, new_ms, metrics

    def _rows(state_arr, ids):
        return None if state_arr is None else state_arr[ids]

    def client_step(ps, client_states: ClientStates, model_state, batch, lr,
                    rng: Optional[torch.Generator]):
        """Phase 1: the round's data-weighted transmit (a dense vector in
        the resident layout, or the ``(r, c_pad)`` table in sketch mode)
        with the client-state rows in a ``RoundContext``, the model state,
        per-client metrics. ``lr`` is the current learning rate (fedavg's
        local SGD reads it); ``rng`` draws DP noise and the dropout masks
        of a loss that has dropout (GPT-2)."""
        ids = batch["client_ids"].to(torch.int64)
        worker_mask = batch["worker_mask"]
        data = seq_slice({k: v for k, v in batch.items()
                          if k not in ("client_ids", "worker_mask")},
                         cfg.seq_sharded_keys, seq_group)
        W = worker_mask.shape[0]
        # this rank's slots (all of them without a group)
        lo, hi = group.slots(W) if group is not None else (0, W)
        local_mask = worker_mask[lo:hi]
        vel_rows = _rows(client_states.velocities, ids)
        err_rows = _rows(client_states.errors, ids)
        stale_rows = _rows(client_states.weights, ids)
        if fused_grad:
            if stream:
                # the streaming phase's sum is already the table
                total, new_ms, metrics = fused_clients_stream(
                    ps, model_state, data, local_mask, rng, lo, hi)
            else:
                total, new_ms, metrics = fused_clients(
                    ps, model_state, data, local_mask, rng, lo, hi)
            new_vel, new_err = vel_rows, err_rows
        else:
            # a slot draws only dropout masks and worker DP noise; without
            # either the round generator is left as it was
            gens = (slot_generators(rng, W)[lo:hi] if slot_draws
                    else [None] * (hi - lo))

            def mine(x):
                return None if x is None else x[lo:hi]

            total, new_vel, new_err, new_ms, metrics = per_client_path(
                ps, mine(vel_rows), mine(err_rows), mine(stale_rows),
                model_state, {k: v[lo:hi] for k, v in data.items()}, lr,
                gens, local_mask)
            if group is not None:
                # every rank keeps the whole replicated client state
                new_vel = (None if new_vel is None
                           else all_gather_tiled(new_vel, group))
                new_err = (None if new_err is None
                           else all_gather_tiled(new_err, group))
        if group is not None:
            # the W slots' metrics on every rank, in slot order
            metrics = tuple(all_gather_tiled(
                torch.stack(metrics, 1).contiguous(), group).unbind(1))
        if sketch_after_sum and not stream:
            # one sketch of the dense sum; the fused gradient is already in
            # the (T, S, 128) layout
            total = (sketch_chunks(sketch, total) if chunked and fused_grad
                     else sketch_vec(sketch, total))
        # data-weighted average
        total_count = torch.clamp(batch["mask"].sum(), min=1.0)
        if server_shard:
            # the sharded server reduces, then divides
            gradient, count = total, total_count
        elif group is not None:
            gradient, count = all_reduce_sum(total, group) / total_count, \
                None
        else:
            gradient, count = total / total_count, None
        ctx = RoundContext(gradient, ids, worker_mask, vel_rows, err_rows,
                           stale_rows, new_vel, new_err, count)
        return ctx, average_model_state(new_ms, model_state, local_mask,
                                        group), metrics

    def server_step(ps, server_state: ServerState,
                    client_states: ClientStates, ctx: RoundContext, lr,
                    rng: Optional[torch.Generator], sr=None):
        """Phase 2: the server rule, the weight update, and the client-state
        scatter. Returns (new weights, new server state, client states),
        then the guard verdict (``cfg.guards``) and the metric vector
        (``cfg.telemetry``); the client-state arrays are updated in place.
        ``sr``: the quantized legs' stochastic-rounding generators
        (``{"up": ..., "down": ...}``, the sharded server only)."""
        # fedavg applies the lr on the clients; the server sees lr = 1
        eff_lr = 1.0 if wcfg.mode == "fedavg" else lr
        resketched = None
        if server_shard:
            update, new_state, resketched = sharded_server_update(
                ctx.gradient, server_state, scfg, eff_lr, ctx.count, group,
                sketch=sketch, layout=layout, rng=rng, plan=plan, sr=sr,
                lowering=lowering)
        else:
            update, new_state = server_update(ctx.gradient, server_state,
                                              scfg, eff_lr, sketch=sketch,
                                              rng=rng, layout=layout)
        new_ps = ps - update

        # the health guard: one verdict gates the whole transition by
        # select (never by a product: NaN x 0 is NaN), so a tripped round
        # leaves the weights, the server state with its carries and every
        # client row as they were
        guard_ok = transmit_max = None
        if cfg.guards or cfg.telemetry:
            transmit_max = torch.linalg.vector_norm(ctx.gradient,
                                                    ord=float("inf"))
        if cfg.guards:
            guard_ok = round_health(ctx.gradient, new_ps, cfg.guard_max_abs,
                                    transmit_max=transmit_max,
                                    group=group if server_shard else None)
            new_ps = torch.where(guard_ok, new_ps, ps)
            new_state = ServerState(*(
                _select(guard_ok, new, old)
                for new, old in zip(new_state, server_state)))

        # the server's masks of the participating clients' state:
        # true_topk's momentum factor masking of local velocities at the
        # global top-k coordinates; sketch mode's error feedback and
        # momentum masking of the clients' sketch-space tables at the
        # nonzero cells of the re-sketched update
        keep_vel = keep_err = None
        if wcfg.mode == "true_topk" and wcfg.local_momentum > 0:
            keep_vel = (update == 0).to(torch.float32)[None, :]
        elif wcfg.mode == "sketch" and (wcfg.has_velocity or wcfg.has_error):
            if resketched is not None and not torch.is_tensor(eff_lr):
                # the sharded server's summed partial re-sketch of the
                # unscaled update: linear, so scaled by the scalar lr it
                # is the re-sketch of the scaled update
                sketched_update = resketched * eff_lr
            else:
                resketch = sketch_chunks if chunked else sketch_vec
                sketched_update = resketch(sketch, update)
            cell_keep = (sketched_update == 0).to(torch.float32)[None]
            keep_vel = keep_err = cell_keep

        def gated(delta):
            """A quarantined round's row deltas become -0.0, which leaves
            every row bit for bit as it was (x + -0.0 == x, -0.0
            included)."""
            if guard_ok is None:
                return delta
            return torch.where(guard_ok, delta, -0.0)

        def scatter(state_arr, old_rows, new_rows, keep):
            """Add each participating slot's (masked new row - old row) to
            its client's row, in place. A padded slot repeats client id 0
            with wmask 0, so its delta is exactly 0: index_add_ then adds
            +0.0 to the row a real slot of client 0 updates (or leaves),
            and x + 0.0 == x, so duplicate ids stay exact in any order."""
            if state_arr is None:
                return None
            final = new_rows if keep is None else new_rows * keep
            w = ctx.wmask.reshape((-1,) + (1,) * (old_rows.ndim - 1))
            return state_arr.index_add_(0, ctx.ids,
                                        gated((final - old_rows) * w))

        cs = ClientStates(
            velocities=scatter(client_states.velocities, ctx.vel_rows,
                               ctx.new_vel, keep_vel),
            errors=scatter(client_states.errors, ctx.err_rows, ctx.new_err,
                           keep_err),
            weights=client_states.weights)
        if wcfg.do_topk_down and cs.weights is not None:
            # the participating clients' stale weights advance to the
            # weights they used this round; wmask gates the delta as above
            used = torch.stack([get_new_worker_weights(ps, s, wcfg.k, True)
                                for s in ctx.stale_rows])
            w = ctx.wmask.reshape(-1, 1)
            cs.weights.index_add_(0, ctx.ids,
                                  gated((used - ctx.stale_rows) * w))
        ret = (new_ps, new_state, cs)
        if cfg.guards:
            ret += (guard_ok,)
        if cfg.telemetry:
            # after the select: a quarantined round shows what tripped in
            # its transmit and update, and the carries it kept
            ret += (device_round_metrics(
                ctx.gradient, update, new_ps, new_state, guard_ok=guard_ok,
                hists=cfg.telemetry_hist,
                group=group if server_shard else None,
                sharded_state=server_shard and wcfg.mode != "sketch",
                transmit_max=transmit_max),)
        return ret

    def val_step(ps, model_state, batch):
        w = layout.unchunk(ps) if (chunked and ps.ndim != 1) else ps
        # the loss sums its token sums over seq: the metrics come back
        # replicated
        return forward_metrics(compute_loss_val, params.params(w),
                               model_state,
                               seq_slice(batch, cfg.seq_sharded_keys,
                                         seq_group))

    return FederatedSteps(client_step=client_step, server_step=server_step,
                          val_step=val_step, layout=layout,
                          stream_segments=stream_segs,
                          stream_groups=stream_groups)
