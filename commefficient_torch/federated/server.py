"""Server-side update rules: the port of
``commefficient_tpu/federated/server.py`` (the unsharded server), the five
compression modes with error feedback and virtual momentum.

``server_update`` takes the data-weighted round gradient (a dense ``(d,)``
vector, or the ``(r, c_pad)`` table in sketch mode) and the server's
``(velocity, error)`` state and returns the weight update (times the
learning rate) and the new state:

- ``fedavg``: the averaged weight delta plus virtual momentum (the lr was
  applied on the clients; the round passes lr = 1);
- ``uncompressed``: the momentum-accumulated gradient, with server DP noise
  under ``dp_mode == "server"`` (drawn from an explicit
  ``torch.Generator``);
- ``true_topk``: the top-k of the virtual error, error and velocity zeroed
  where it kept a coordinate;
- ``local_topk``: the clients' already top-k'd sum plus virtual momentum;
- ``sketch`` (FetchSGD): momentum and error accumulate in table space, the
  update is the top-k of the error table's median-of-rows estimates, and
  error and velocity are zeroed at the nonzero cells of the update's
  re-sketch. With ``fused_epilogue`` (``--fused_epilogue``) and the chunk
  layout, the mask, the update and its re-sketch come from one epilogue
  sweep over the estimates (``ops/sketch.fused_epilogue_chunks``),
  bit-identical to the composed pair.

``sharded_server_update`` is the sharded server data plane
(``--server_shard``, the JAX package's ``sharded_server_update``): each
rank of a ``parallel/mesh.ClientGroup`` takes its unreduced transmit sum,
the reduce runs in the server step (reduce-scatter of the dense
transmit, all-reduce of the sketch table; exact, or a quantized
error-feedback collective under a ``CollectivePlan``), the ``/count``
division follows it, the server rule runs on this rank's slice (dense
modes: a ``d_pad / n`` slice of velocity and error, ``d_pad = n * ceil(d /
n)``; sketch mode: the replicated table algebra and ``ceil(T / n)`` chunks
of the estimate plane, ``t0 = rank * ceil(T / n)``), the top-k threshold
comes from the counts exchanged over the group, and the update slice is
all-gathered (quantized under a quantized downlink leg). On the 2-D
(clients x shard) grid the group is the server reduce tuple (rank ``p``,
size ``N``), and a leg that a per-axis plan lowers to an ``((axis,
dtype), ...)`` tuple runs the hierarchical collectives over the grid's
axis subgroups: the table by ``hierarchical_psum``, the dense uplink by
``hierarchical_psum_scatter``, the downlink by
``hierarchical_all_gather``, each with a tuple of per-level carries (None
at float32 levels). Server DP noise comes from its own generator, never
from the stochastic-rounding streams, so the JAX package's fold of the
noise key under a quantized plan has no counterpart here: the streams
are already independent.

The legality asserts of ``ServerConfig`` are the JAX package's, verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from commefficient_torch.ops.flat import ChunkLayout
from commefficient_torch.ops.collectives import (
    DEFAULT_QUANT_BLOCK,
    FP32_PLAN,
    PLAN_LEGS,
    all_gather_tiled,
    all_reduce_sum,
    hierarchical_all_gather,
    hierarchical_psum,
    hierarchical_psum_scatter,
    leg_quantized,
    quantized_all_gather,
    quantized_psum,
    quantized_psum_scatter,
    reduce_scatter_sum,
)
from commefficient_torch.ops.sketch import (
    CountSketch,
    estimates_chunks,
    estimates_chunks_local,
    fused_epilogue_chunks,
    fused_epilogue_chunks_local,
    sketch_chunks,
    sketch_chunks_local,
    unsketch_chunks,
)
from commefficient_torch.ops.topk import topk, topk_dense_nd

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed")
ERROR_TYPES = ("none", "local", "virtual")


@dataclass(frozen=True)
class ServerConfig:
    """Static server config."""

    mode: str
    error_type: str = "none"
    k: int = 0
    grad_size: int = 0
    virtual_momentum: float = 0.0
    local_momentum: float = 0.0
    do_dp: bool = False
    dp_mode: str = "worker"
    noise_multiplier: float = 0.0
    # sketch mode, chunked layout: one epilogue sweep for the threshold
    # mask, the update and its re-sketch
    fused_epilogue: bool = False

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.error_type in ERROR_TYPES, self.error_type
        if self.mode == "fedavg":
            assert self.error_type == "none", "fedavg requires error_type=none"
            assert self.local_momentum == 0, "fedavg requires local_momentum=0"
        if self.mode == "true_topk":
            assert self.error_type == "virtual", "true_topk requires virtual error"
        if self.mode == "local_topk":
            assert self.error_type in ("local", "none")
        if self.mode == "sketch":
            if self.error_type == "local":
                assert self.virtual_momentum == 0, \
                    "sketch + local error carries momentum locally: set " \
                    "--virtual_momentum 0"
            if self.error_type == "virtual":
                assert self.local_momentum == 0, \
                    "sketch + virtual error carries momentum on the " \
                    "server: set --local_momentum 0 (the CLI default 0.9 " \
                    "mirrors the reference and must be overridden for " \
                    "the FetchSGD recipe)"


class ServerState(NamedTuple):
    """(velocity, error): ``(num_rows, c_pad)`` tables in sketch mode,
    else ``(grad_size,)`` vectors; under the sharded server's dense modes
    this rank's ``(d_pad / n,)`` slices.

    The quantized collectives' error-feedback carries (this rank's; None
    where the leg is exact): ``qres``, the uplink's (the dense transmit
    reduce, ``(d_pad,)``) or the table leg's (``(r, c_pad)``) remainder;
    ``dres``, the downlink's remainder of this rank's update tile (sketch
    mode ``(ceil(T / n), S, 128)``, dense ``(d_pad / n,)``). A leg that a
    per-axis plan lowers hierarchically carries a tuple of slots aligned
    with its lowering, None at float32 levels: uplink slot ``j`` has the
    shape of level ``j``'s input (the dense tile divided by the sizes of
    the axes reduced before it; the table at every level), downlink slot
    ``j`` that of level ``j``'s gather input (the gathered layout divided
    by the sizes of axes ``0..j``), the same on the ranks along the axes
    after ``j``."""

    velocity: torch.Tensor
    error: torch.Tensor
    qres: Optional[torch.Tensor] = None
    dres: Optional[torch.Tensor] = None


def leg_lowerings(plan, lowering=None) -> dict:
    """``{leg: dtype | ((axis, dtype), ...)}``: ``lowering`` (a per-axis
    plan resolved on the grid, ``ops/collectives.plan_lowering``), else
    the flat plan's dtypes."""
    if lowering is not None:
        return lowering
    plan = FP32_PLAN if plan is None else plan
    assert not plan.per_axis, \
        "per-axis collective plans must pass lowering= (the " \
        "resolve_leg_lowering dict): the leg strings alone do not size " \
        "the per-axis carry slots"
    return {leg: getattr(plan, leg) for leg in PLAN_LEGS}


def init_server_state(cfg: ServerConfig,
                      sketch: Optional[CountSketch] = None,
                      device=None, shard_n: int = 0,
                      plan=None, lowering=None,
                      axis_sizes=None) -> ServerState:
    """Zero state on ``device`` (the sketch's device in sketch mode, else
    ``device``, default ``cuda``). ``shard_n > 0`` is the sharded server
    over a group of that size (this rank's slices of dense state);
    ``plan`` (a ``CollectivePlan``) decides which carries exist: ``qres``
    where the mode's uplink leg (``uplink``, sketch mode ``table``) is
    quantized, ``dres`` where the ``downlink`` is. A quantized leg needs
    ``shard_n``. ``lowering`` (a per-axis plan's, with ``axis_sizes``,
    ``{axis: size}``) gives a hierarchical leg its tuple of per-level
    carries (see ``ServerState``)."""
    lowering = leg_lowerings(plan, lowering)
    if cfg.mode == "sketch":
        assert sketch is not None
        shape, device = sketch.table_shape, sketch.device
    else:
        d = cfg.grad_size
        shape = (-(-d // shard_n),) if shard_n else (d,)
        device = torch.device(device if device is not None else "cuda")

    def zeros(sh):
        return torch.zeros(sh, dtype=torch.float32, device=device)

    up = lowering["table"] if cfg.mode == "sketch" else lowering["uplink"]
    down = lowering["downlink"]
    if leg_quantized(up) or leg_quantized(down):
        assert shard_n > 0, \
            "quantized collective legs require --server_shard"
    # the dense transmit (d_pad) and the gathered update layout
    n = max(shard_n, 1)
    up_full = shape if cfg.mode == "sketch" else (shape[0] * n,)
    down_full = ((-(-sketch.T // n) * n, sketch.sublanes, 128)
                 if cfg.mode == "sketch" else (shape[0] * n,))
    qres = dres = None
    if isinstance(up, tuple):
        assert axis_sizes is not None, \
            "a hierarchical lowering needs axis_sizes={axis: size}"
        slots, seen = [], 1
        for ax, dt in up:
            slots.append(None if dt == "float32" else zeros(
                up_full if cfg.mode == "sketch"
                else (up_full[0] // seen,)))
            seen *= int(axis_sizes[ax])
        qres = tuple(slots)
    elif up != "float32":
        qres = zeros(up_full)
    if isinstance(down, tuple):
        assert axis_sizes is not None, \
            "a hierarchical lowering needs axis_sizes={axis: size}"
        slots, seen = [], 1
        for ax, dt in down:
            seen *= int(axis_sizes[ax])
            slots.append(None if dt == "float32" else zeros(
                (down_full[0] // seen,) + down_full[1:]))
        dres = tuple(slots)
    elif down != "float32":
        dres = zeros((down_full[0] // n,) + down_full[1:])
    return ServerState(velocity=zeros(shape), error=zeros(shape),
                       qres=qres, dres=dres)


def server_update(gradient: torch.Tensor, state: ServerState,
                  cfg: ServerConfig, lr, sketch: Optional[CountSketch] = None,
                  rng: Optional[torch.Generator] = None,
                  layout: Optional[ChunkLayout] = None
                  ) -> Tuple[torch.Tensor, ServerState]:
    """One server step: the aggregated round gradient -> (update x lr, new
    state). ``layout`` (sketch mode only) selects the chunked-resident
    data plane: the update is in the ``(T, S, 128)`` chunk layout, else
    flat ``(d,)``. ``rng`` is the generator of server DP noise
    (``uncompressed`` with ``dp_mode == "server"``)."""
    helper = {
        "fedavg": _fedavg,
        "uncompressed": _uncompressed,
        "true_topk": _true_topk,
        "local_topk": _local_topk,
        "sketch": _sketched,
    }[cfg.mode]
    if cfg.mode == "sketch":
        return helper(gradient, state, cfg, lr, sketch, layout)
    assert layout is None, "chunked-resident layout is sketch-mode only"
    if cfg.mode == "uncompressed":
        return helper(gradient, state, cfg, lr, rng)
    return helper(gradient, state, cfg, lr)


def _fedavg(avg_update, state, cfg, lr):
    # lr already applied on the clients; the round passes lr = 1
    velocity = avg_update + cfg.virtual_momentum * state.velocity
    return velocity, ServerState(velocity, state.error)


def _uncompressed(gradient, state, cfg, lr, rng):
    velocity = gradient + cfg.virtual_momentum * state.velocity
    update = velocity
    if cfg.do_dp and cfg.dp_mode == "server":
        assert rng is not None, "server DP needs a generator"
        update = update + cfg.noise_multiplier * torch.randn(
            update.shape, generator=rng, dtype=update.dtype,
            device=update.device)
    return update * lr, ServerState(velocity, state.error)


def _true_topk(gradient, state, cfg, lr):
    velocity = gradient + cfg.virtual_momentum * state.velocity
    error = state.error + velocity
    update = topk(error, cfg.k)
    nz = update != 0
    # error feedback and momentum factor masking at the chosen coordinates
    zero = torch.zeros((), dtype=error.dtype, device=error.device)
    error = torch.where(nz, zero, error)
    velocity = torch.where(nz, zero, velocity)
    return update * lr, ServerState(velocity, error)


def _local_topk(local_topk_grad, state, cfg, lr):
    # no virtual error and no masking: the clients top-k'd their transmits
    velocity = local_topk_grad + cfg.virtual_momentum * state.velocity
    return velocity * lr, ServerState(velocity, state.error)


def _sketched(sketched_grad, state, cfg, lr, sketch: CountSketch,
              layout: Optional[ChunkLayout] = None):
    velocity = sketched_grad + cfg.virtual_momentum * state.velocity
    if cfg.error_type == "virtual":
        error = state.error + velocity
    else:  # "local", and "none": unsketch the velocity (JAX deviation note)
        error = velocity
    if layout is not None and cfg.fused_epilogue:
        upd3, sketched_update = fused_epilogue_chunks(
            sketch, estimates_chunks(sketch, error), cfg.k)
    else:
        upd3 = unsketch_chunks(sketch, error, cfg.k)
        sketched_update = sketch_chunks(sketch, upd3)
    update = upd3 if layout is not None else sketch.chunk_layout.unchunk(upd3)
    cell_nz = sketched_update != 0
    zero = torch.zeros((), dtype=error.dtype, device=error.device)
    if cfg.error_type == "virtual":
        error = torch.where(cell_nz, zero, error)
    velocity = torch.where(cell_nz, zero, velocity)
    if cfg.error_type == "local":
        # the reference aliases Verror and Vvelocity after masking
        error = velocity
    return update * lr, ServerState(velocity, error)


def round_health(transmit: torch.Tensor, new_ps: torch.Tensor,
                 max_abs: float = 0.0, transmit_max=None, group=None
                 ) -> torch.Tensor:
    """The round's health verdict as a 0-dim bool device tensor (no host
    sync): True iff the transmit and the candidate weights are all finite
    and, when ``max_abs > 0``, every weight is within ``max_abs`` (the
    JAX package's ``round_health``). A tensor is all finite iff its
    largest magnitude is (NaN propagates through the max), so one
    reduction a tensor decides it; ``transmit_max`` is the transmit's if
    the caller has it. Under ``--server_shard`` (``group``) the transmit
    is this rank's unreduced sum: the verdicts are AND-ed over the group
    (one all-reduce of a scalar), so every rank applies or quarantines
    the round alike; the weights are the same on every rank."""
    inf = float("inf")
    if transmit_max is None:
        transmit_max = torch.linalg.vector_norm(transmit, ord=inf)
    ps_max = torch.linalg.vector_norm(new_ps, ord=inf)
    ok = torch.isfinite(transmit_max) & torch.isfinite(ps_max)
    if max_abs > 0:
        ok = ok & (ps_max <= max_abs)
    if group is not None:
        bad = all_reduce_sum((~ok).to(torch.float32), group)
        ok = bad == 0
    return ok


def sharded_server_update(transmit_local: torch.Tensor, state: ServerState,
                          cfg: ServerConfig, lr, count, group,
                          sketch: Optional[CountSketch] = None,
                          layout: Optional[ChunkLayout] = None,
                          rng: Optional[torch.Generator] = None, plan=None,
                          sr: Optional[dict] = None, lowering=None,
                          u: Optional[dict] = None):
    """One sharded server step on this rank of ``group`` (a
    ``ClientGroup``; on the 2-D grid the reduce tuple). ``transmit_local``
    is this rank's UNREDUCED transmit sum (the ``(r, c_pad)`` table, or
    the flat ``(d,)`` sum); ``count`` the round's data count, divided out
    after the reduce, so the reduced sum is the replicated round's.
    ``state`` holds this rank's slices. ``plan`` picks each leg's wire
    dtype, ``lowering`` (``ops/collectives.plan_lowering``) a per-axis
    plan's levels; a quantized leg draws its stochastic-rounding uniforms
    from ``sr[leg]`` (``"up"``, ``"down"``: a generator, or a tuple a
    level, ``ops/collectives.level_sr_generators``), or takes them from
    ``u[leg]`` (the same layout; a test passes the JAX package's), and
    carries its remainder in ``qres`` / ``dres``. ``rng`` draws server DP
    noise: one ``(d_pad,)`` draw on every rank, sliced locally, so the
    ranks agree on the noise vector.

    Returns ``(the lr-scaled full update, this rank's new state, the
    re-sketched update table or None)``: in sketch mode the sum of the
    ranks' partial re-sketches, whose nonzero cells mask the state (the
    round reuses it for the client tables)."""
    lowering = leg_lowerings(plan, lowering)
    sr = sr or {}
    u = u or {}
    n, rank = group.size, group.rank
    up = lowering["table"] if cfg.mode == "sketch" else lowering["uplink"]
    down = lowering["downlink"]
    up_q, down_q = leg_quantized(up), leg_quantized(down)
    if up_q:
        assert state.qres is not None, \
            "quantized uplink/table leg needs the qres carry " \
            "(init_server_state plan=)"
    if down_q:
        assert state.dres is not None, \
            "quantized downlink leg needs the dres carry " \
            "(init_server_state plan=)"
    zero = torch.zeros((), dtype=torch.float32,
                       device=transmit_local.device)

    def gather(upd_local, block):
        """The update all-gather: exact, quantized, or level by level."""
        if isinstance(down, tuple):
            return hierarchical_all_gather(
                upd_local, down, group, sr.get("down"), residuals=state.dres,
                block=block, u=u.get("down"))
        if down_q:
            return quantized_all_gather(
                upd_local, group, sr.get("down"), residual=state.dres,
                block=block, dtype=down, u=u.get("down"))
        return all_gather_tiled(upd_local, group), state.dres

    if cfg.mode == "sketch":
        assert sketch is not None and layout is not None
        if isinstance(up, tuple):
            table, new_qres = hierarchical_psum(
                transmit_local, up, group, sr.get("up"),
                residuals=state.qres, block=sketch.c_pad, u=u.get("up"))
        elif up_q:
            # one scale a table row (c_pad = S * 128)
            table, new_qres = quantized_psum(
                transmit_local, group, sr.get("up"), residual=state.qres,
                block=sketch.c_pad, dtype=up, u=u.get("up"))
        else:
            table = all_reduce_sum(transmit_local.clone(), group)
            new_qres = state.qres
        table = table / count
        velocity = table + cfg.virtual_momentum * state.velocity
        if cfg.error_type == "virtual":
            error = state.error + velocity
        else:  # "local", and "none" (see _sketched)
            error = velocity
        Tn = -(-sketch.T // n)
        t0 = rank * Tn
        est_local = estimates_chunks_local(sketch, error, t0, Tn)
        if cfg.fused_epilogue:
            upd_local, part = fused_epilogue_chunks_local(
                sketch, est_local, t0, cfg.k, group)
        else:
            upd_local = topk_dense_nd(est_local, cfg.k, group)
            part = sketch_chunks_local(sketch, upd_local, t0)
        resketched = all_reduce_sum(part, group)
        cell_nz = resketched != 0
        if cfg.error_type == "virtual":
            error = torch.where(cell_nz, zero, error)
        velocity = torch.where(cell_nz, zero, velocity)
        if cfg.error_type == "local":
            error = velocity
        # one scale a resident (S, 128) chunk
        full, new_dres = gather(upd_local, sketch.sublanes * 128)
        update = full[:sketch.T]
        return (update * lr, ServerState(velocity, error, new_qres,
                                         new_dres), resketched)

    d = cfg.grad_size
    d_pad = -(-d // n) * n
    x = torch.nn.functional.pad(transmit_local, (0, d_pad - d))
    if isinstance(up, tuple):
        tile, new_qres = hierarchical_psum_scatter(
            x, up, group, sr.get("up"), residuals=state.qres,
            u=u.get("up"))
    elif up_q:
        tile, new_qres = quantized_psum_scatter(
            x, group, sr.get("up"), residual=state.qres, dtype=up,
            u=u.get("up"))
    else:
        tile, new_qres = reduce_scatter_sum(x, group), state.qres
    grad = tile / count
    velocity = grad + cfg.virtual_momentum * state.velocity
    error = state.error
    if cfg.mode == "true_topk":
        error = error + velocity
        upd_local = topk_dense_nd(error, cfg.k, group)
        nz = upd_local != 0
        error = torch.where(nz, zero, error)
        velocity = torch.where(nz, zero, velocity)
    else:  # uncompressed, local_topk, fedavg: the update is the velocity
        upd_local = velocity
        if cfg.mode == "uncompressed" and cfg.do_dp \
                and cfg.dp_mode == "server":
            assert rng is not None, "server DP needs a generator"
            per = d_pad // n
            noise = torch.randn(d_pad, generator=rng, dtype=torch.float32,
                                device=upd_local.device)
            upd_local = upd_local + cfg.noise_multiplier * \
                noise[rank * per:(rank + 1) * per]
    full, new_dres = gather(upd_local, DEFAULT_QUANT_BLOCK)
    update = full[:d]
    return (update * lr, ServerState(velocity, error, new_qres, new_dres),
            None)
