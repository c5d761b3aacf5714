"""The sharded server data plane's transmit collectives: the port of
``commefficient_tpu/ops/collectives.py`` (part 2, the flat plans).

Every collective takes a ``parallel/mesh.ClientGroup`` (its process group,
rank and size) and runs on the group's backend (NCCL on the card):

- ``reduce_scatter_sum`` / ``all_gather_tiled``: the reduce-scatter ->
  per-shard update -> all-gather pair of the sharded server
  (``--server_shard``);
- ``psum_repct`` / ``ident_psumct``: the all-reduce whose backward is the
  identity and the identity whose backward is an all-reduce
  (``torch.autograd.Function``s with a ``vmap`` rule), which the
  seq-parallel GPT-2 forward and loss run on the ``seq`` axis;
- ``send_recv``: one point-to-point exchange with a neighbour (the ring
  attention's shift, ``parallel/ring.py``, and the pipeline's stage hop,
  ``parallel/pipeline.py``): ``batch_isend_irecv`` on the tensor's own
  device, except for ``gloo`` on a CUDA tensor, whose buffer is staged
  through host memory (gloo's point-to-point reads and writes the raw
  buffer and moves host memory only: ``writev ... Bad address`` on
  device memory);
- ``quantized_psum_scatter`` / ``quantized_psum`` /
  ``quantized_all_gather``: block-scaled stochastic-rounding collectives
  with an explicit error-feedback remainder. Each rank adds its carried
  remainder to its contribution, quantizes it (one float32 scale a
  block), moves the payload and the scales (one ``all_to_all`` for the
  reduces, one ``all_gather`` for the gather), and the receiver
  dequantizes (and sums in float32). The un-transmitted remainder ``(x +
  residual) - Q(x + residual)`` is returned, persisted by the caller
  (``ServerState.qres`` for the reduce legs, ``dres`` for the gather) and
  folded into the next round's contribution.

Wire dtypes (``quantize_blocks``): ``int8`` (scale ``max|block| / 127``,
integer stochastic rounding), ``fp8_e4m3`` (``/ 448``, stochastic
rounding between the two neighbouring e4m3fn values; the value is clipped
to 448 first, since a cast to ``torch.float8_e4m3fn`` does not saturate)
and ``int4`` (``/ 7``, two values nibble-packed a byte). ``payload_bytes``
prices each.

The JAX package computes the quantizers in XLA, not in a Pallas kernel;
here they are plain PyTorch on tensors. The stochastic-rounding uniforms
are an argument of the rounding helpers (``u``): the collectives draw them
from an explicit ``torch.Generator`` (``sr_generator``: seeded from the
run's seed, the round, the rank and the leg), and a test can pass the JAX
package's own ``jax.random.uniform`` draws instead and compare payloads bit
for bit. ``CollectivePlan`` / ``parse_collective_plan`` choose the wire
dtype of each leg (``uplink``: the dense transmit reduce, ``table``: the
sketch-table exchange, ``downlink``: the update all-gather).

Per-axis plans (part 3 of the JAX module). On the 2-D (clients x shard)
grid a leg may carry slash-joined ``axis:dtype`` pairs
(``uplink=ici:fp32/dcn:int8``; ``ici`` / ``dcn`` are placement aliases of
``parallel/mesh.mesh_axis_placement``, mesh axis names work too, axes no
entry covers stay float32). ``resolve_leg_lowering`` turns such a leg
into an ordered ``((axis, dtype), ...)`` lowering over the server reduce
axes (``shard`` first, ``clients`` last), collapsed to the flat dtype when
every level agrees; ``hierarchical_psum_scatter`` / ``hierarchical_psum``
/ ``hierarchical_all_gather`` run it level by level over the grid's axis
subgroups, each quantized level with its own error-feedback carry. A
level's stochastic-rounding stream is keyed on ``(seed, round, leg,
level, this rank's index along the level's axis)``
(``level_sr_generators``), never on the global rank: in the gather,
sibling ranks along the axes already gathered quantize identical data
and must draw identical uniforms, or the replicas' updates diverge.

``autotune_collective_plan`` (``--collective_plan auto``) probes each
{leg x dtype} candidate's quantize -> dequantize round trip on the
JAX package's calibration data and picks the cheapest dtype a leg within
an error budget, as the JAX package does; the round trip is timed with
CUDA events on the card and the host clock on the CPU.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_QUANT_BLOCK", "QUANT_DTYPES", "WIRE_DTYPES", "PLAN_LEGS",
    "PLACEMENT_ALIASES", "payload_bytes", "reduce_scatter_sum",
    "all_gather_tiled", "all_reduce_sum", "quantize_blocks",
    "dequantize_blocks", "quantized_psum_scatter", "quantized_psum",
    "quantized_all_gather", "hierarchical_psum_scatter",
    "hierarchical_psum", "hierarchical_all_gather", "leg_axis_entries",
    "leg_quantized", "resolve_leg_lowering", "plan_lowering",
    "CollectivePlan", "FP32_PLAN", "parse_collective_plan",
    "plan_from_reduce_dtype", "sr_generator", "level_sr_generators",
    "autotune_collective_plan", "psum_repct", "ident_psumct", "send_recv",
]

# 64 sublanes x 128 lanes per float32 scale, as in the JAX package; the
# chunked sketch plane passes its (S, 128) chunk size, the table exchange
# one table row (c_pad)
DEFAULT_QUANT_BLOCK = 64 * 128

_INT8_MAX = 127.0
_INT4_MAX = 7.0
_FP8_MAX = 448.0          # max finite float8_e4m3fn
_FP8_MAX_BITS = 0x7E      # magnitude bits of 448.0 (0x7F is NaN)

QUANT_DTYPES = ("int8", "fp8_e4m3", "int4")
WIRE_DTYPES = ("float32",) + QUANT_DTYPES
PLAN_LEGS = ("uplink", "table", "downlink")
# placement aliases a per-axis plan entry may use instead of an axis name
PLACEMENT_ALIASES = ("ici", "dcn")


def payload_bytes(size: int, dtype: str = "int8",
                  block=DEFAULT_QUANT_BLOCK) -> int:
    """Wire bytes of a ``size``-element operand at ``dtype``: 4 B an
    element at float32; else the payload (1 B an element, int4 packed
    ``ceil(b / 2)`` bytes a ``b``-element block) plus one float32 scale a
    block."""
    assert dtype in WIRE_DTYPES, dtype
    size = int(size)
    if dtype == "float32":
        return 4 * size
    block = int(DEFAULT_QUANT_BLOCK if block is None else block)
    nb = -(-size // block)
    if dtype == "int4":
        nfull, tail = divmod(size, block)
        elem = nfull * ((block + 1) // 2) + (tail + 1) // 2
    else:
        elem = size
    return elem + 4 * nb


def _pg(cg):
    return None if cg is None else cg.group


def all_reduce_sum(x: torch.Tensor, cg) -> torch.Tensor:
    """``x`` summed over the group (in place; returns ``x``)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_pg(cg))
    return x


def reduce_scatter_sum(x: torch.Tensor, cg) -> torch.Tensor:
    """Sum ``x`` over the group and return this rank's dim-0 tile
    (``x.shape[0]`` divisible by the group's size)."""
    n = cg.size
    assert x.shape[0] % n == 0, (tuple(x.shape), n)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=_pg(cg))
    return out


def all_gather_tiled(x: torch.Tensor, cg) -> torch.Tensor:
    """The ranks' dim-0 tiles concatenated in rank order (exact data
    movement)."""
    out = torch.empty((cg.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=_pg(cg))
    return out


def _peer(cg, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``cg``'s process group."""
    if cg.group is None:
        return group_rank
    return dist.get_global_rank(cg.group, group_rank)


def send_recv(x: torch.Tensor, cg, dst: Optional[int],
              src: Optional[int]) -> Optional[torch.Tensor]:
    """Send ``x`` to group rank ``dst`` and return what group rank ``src``
    sent (a tensor like ``x``), in one ``batch_isend_irecv``; ``dst``
    None sends nothing, ``src`` None receives nothing (and returns
    None). The transport follows the group's backend name
    (``ClientGroup.backend``): ``gloo`` on a CUDA tensor stages through
    host memory."""
    staged = cg.backend == "gloo" and x.is_cuda
    send = x.contiguous()
    if staged:
        send = send.cpu()
    recv = None if src is None else torch.empty_like(send)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send, _peer(cg, dst),
                              group=cg.group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv, _peer(cg, src),
                              group=cg.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if recv is None:
        return None
    return recv.to(x.device) if staged else recv


def _all_to_all(x: torch.Tensor, cg) -> torch.Tensor:
    """Send dim-0 tile ``j`` to rank ``j``; receive every rank's tile for
    this rank, stacked in rank order."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=_pg(cg))
    return out


# --------------------------------------------------------------------------
# collectives with a pinned backward (the seq-parallel forward)
# --------------------------------------------------------------------------

class _PsumRepct(torch.autograd.Function):
    """All-reduce forward, identity backward. Its ``vmap`` rule runs the
    collective once on the whole batched tensor (the lanes are independent
    and every rank batches the same lanes), so it works inside the fused
    client phase's ``torch.func.vmap``."""

    @staticmethod
    def forward(x, cg):
        return all_reduce_sum(x.clone(memory_format=torch.contiguous_format),
                              cg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return ct, None

    @staticmethod
    def vmap(info, in_dims, x, cg):
        return _PsumRepct.apply(x, cg), in_dims[0]


class _IdentPsumct(torch.autograd.Function):
    """Identity forward, all-reduce backward (``vmap`` as above)."""

    @staticmethod
    def forward(x, cg):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cg = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(
            ct.clone(memory_format=torch.contiguous_format), ctx.cg), None

    @staticmethod
    def vmap(info, in_dims, x, cg):
        return _IdentPsumct.apply(x, cg), in_dims[0]


def psum_repct(x: torch.Tensor, cg) -> torch.Tensor:
    """``x`` summed over the group, with the identity as its backward: the
    right VJP when the output's cotangent is replicated over the group
    (the seq-parallel loss and multiple-choice logit). A plain
    all-reduce's transpose is another all-reduce, which multiplies every
    upstream gradient by the group's size. Also the plain sum of a tensor
    that carries no gradient (an integer count)."""
    return _PsumRepct.apply(x, cg)


def ident_psumct(x: torch.Tensor, cg) -> torch.Tensor:
    """Identity forward (``x`` replicated over the group); the backward
    all-reduces the ranks' partial cotangents."""
    return _IdentPsumct.apply(x, cg)


# --------------------------------------------------------------------------
# quantizers
# --------------------------------------------------------------------------

def _sr_int(y: torch.Tensor, u: torch.Tensor, qmax: float) -> torch.Tensor:
    """Integer stochastic rounding of ``y`` to ``[-qmax, qmax]``:
    ``floor(y) + (u < frac)``."""
    lo = torch.floor(y)
    q = lo + (u < (y - lo)).to(y.dtype)
    return torch.clamp(q, -qmax, qmax)


def _f8_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return bits.view(torch.float8_e4m3fn).to(torch.float32)


def _sr_fp8(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of ``y`` to float8_e4m3fn between the two
    neighbouring representable values (sign-magnitude bit layout, uint8
    bits +-1), with probability proportional to proximity. The magnitude
    is clipped to 448 before the cast (the cast does not saturate)."""
    # jnp.sign keeps the sign of a zero (torch.sign gives +0.0), and the
    # sign of a zero reaches the payload's bits
    sign = torch.where(y == 0, y, torch.sign(y))
    a = torch.clamp(torch.abs(y), max=_FP8_MAX)
    f8 = a.to(torch.float8_e4m3fn)
    c = f8.to(torch.float32)  # the round-to-nearest neighbour
    bits = f8.view(torch.uint8)
    lo_bits = torch.where(c <= a, bits, bits - 1)
    hi_bits = torch.clamp(lo_bits + 1, max=_FP8_MAX_BITS).to(torch.uint8)
    lo = _f8_from_bits(lo_bits)
    hi = _f8_from_bits(hi_bits)
    gap = hi - lo
    pos = gap > 0
    frac = torch.where(pos, (a - lo) / torch.where(pos, gap,
                                                    torch.ones_like(gap)),
                       torch.zeros_like(gap))
    mag = torch.where(u < frac, hi, lo)
    return (sign * mag).to(torch.float8_e4m3fn)


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Two int4 values (float in [-7, 7]) a byte along the last axis:
    ``value + 8`` in 4 bits, the even position in the low nibble; an odd
    last dimension gets one padding nibble (8, a zero)."""
    v = q.to(torch.int32) + 8
    if v.shape[-1] % 2:
        v = torch.cat([v, torch.full(v.shape[:-1] + (1,), 8,
                                     dtype=v.dtype, device=v.device)], -1)
    v = v.reshape(v.shape[:-1] + (-1, 2))
    return (v[..., 0] | (v[..., 1] << 4)).to(torch.uint8)


def _unpack_int4(p: torch.Tensor, block: int) -> torch.Tensor:
    lo = (p & 0xF).to(torch.int32) - 8
    hi = (p >> 4).to(torch.int32) - 8
    q = torch.stack([lo, hi], -1).reshape(p.shape[:-1] + (2 * p.shape[-1],))
    return q[..., :block].to(torch.float32)


def quantize_blocks(x: torch.Tensor, u: torch.Tensor, dtype: str = "int8"):
    """Block-scaled stochastic-rounding quantization of ``x`` (``(...,
    block)``) with the uniforms ``u`` (``x``'s shape, [0, 1)). Returns
    ``(payload, scale)``: one float32 scale a block, ``max|block| /
    qmax``, and the payload in its wire layout (int8; float8_e4m3fn;
    nibble-packed uint8 of ``ceil(block / 2)`` bytes). An all-zero block
    has scale 0 and payload 0."""
    assert dtype in QUANT_DTYPES, dtype
    assert tuple(u.shape) == tuple(x.shape), (tuple(u.shape), tuple(x.shape))
    qmax = {"int8": _INT8_MAX, "fp8_e4m3": _FP8_MAX, "int4": _INT4_MAX}[dtype]
    scale = torch.amax(torch.abs(x), dim=-1) / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = x / safe[..., None]
    if dtype == "int8":
        q = _sr_int(y, u, _INT8_MAX).to(torch.int8)
    elif dtype == "fp8_e4m3":
        q = _sr_fp8(y, u)
    else:
        q = _pack_int4(_sr_int(y, u, _INT4_MAX))
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      dtype: str = "int8", block=None) -> torch.Tensor:
    """Payload and per-block scales -> float32 values (``block`` is
    needed for int4, whose payload is packed)."""
    assert dtype in QUANT_DTYPES, dtype
    if dtype == "int4":
        assert block is not None, "int4 dequantize needs the block size"
        v = _unpack_int4(q, int(block))
    else:
        v = q.to(torch.float32)
    return v * scale[..., None]


def _wire(q: torch.Tensor, dtype: str) -> torch.Tensor:
    # fp8 travels as its bytes
    return q.view(torch.uint8) if dtype == "fp8_e4m3" else q


def _unwire(q: torch.Tensor, dtype: str) -> torch.Tensor:
    return q.view(torch.float8_e4m3fn) if dtype == "fp8_e4m3" else q


def sr_generator(seed: int, round_no: int, rank: int, leg: str,
                 device) -> torch.Generator:
    """The stochastic-rounding generator of one leg on one rank in one
    round, seeded from ``(seed, round, rank, leg)`` (a hash, so streams of
    neighbouring ranks and rounds are unrelated). Seeding is host-only."""
    key = f"{int(seed)}/{int(round_no)}/{int(rank)}/{leg}".encode()
    s = int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1
    return torch.Generator(device=device).manual_seed(s)


def _uniforms(shape, x: torch.Tensor, gen: Optional[torch.Generator],
              u: Optional[torch.Tensor]) -> torch.Tensor:
    if u is not None:
        assert tuple(u.shape) == tuple(shape), (tuple(u.shape), shape)
        return u.to(device=x.device, dtype=torch.float32)
    assert gen is not None, "stochastic rounding needs a generator or u"
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=x.device)


def quantized_psum_scatter(x: torch.Tensor, cg, gen=None,
                           residual: Optional[torch.Tensor] = None,
                           block: int = DEFAULT_QUANT_BLOCK,
                           dtype: str = "int8",
                           u: Optional[torch.Tensor] = None):
    """Error-feedback quantized reduce-scatter over dim 0 (``x.shape[0]``
    divisible by the group's size ``n``). Each destination tile is
    blocked on its own (zero-padded to a block multiple), quantized with
    uniforms ``u`` (``(n, blocks, block)``, else drawn from ``gen``),
    moved by one ``all_to_all`` of payloads and one of scales, and the
    ``n`` dequantized contributions are summed in float32 in rank order.
    Returns ``(this rank's tile of sum_r Q(x_r + residual_r), new
    residual (x + residual) - Q(x + residual))``."""
    n = cg.size
    if residual is not None:
        x = x + residual
    shape = tuple(x.shape)
    assert shape[0] % n == 0, (shape, n)
    per = shape[0] // n
    tile_elems = x.numel() // n
    nbd = -(-tile_elems // block)
    rows = torch.nn.functional.pad(x.reshape(n, tile_elems),
                                   (0, nbd * block - tile_elems))
    xb = rows.reshape(n, nbd, block)
    q, scale = quantize_blocks(xb, _uniforms(xb.shape, x, gen, u), dtype)
    new_residual = (xb - dequantize_blocks(q, scale, dtype, block)) \
        .reshape(n, nbd * block)[:, :tile_elems].reshape(shape)
    q_in = _unwire(_all_to_all(_wire(q, dtype), cg), dtype)
    s_in = _all_to_all(scale, cg)
    parts = dequantize_blocks(q_in, s_in, dtype, block)
    tile = parts[0]
    for j in range(1, n):
        tile = tile + parts[j]
    tile = tile.reshape(-1)[:tile_elems]
    return tile.reshape((per,) + shape[1:]), new_residual


def quantized_psum(x: torch.Tensor, cg, gen=None,
                   residual: Optional[torch.Tensor] = None,
                   block: int = DEFAULT_QUANT_BLOCK, dtype: str = "int8",
                   u: Optional[torch.Tensor] = None):
    """Error-feedback quantized all-reduce: the quantized reduce-scatter
    over a padded flat view, then an exact float32 all-gather, so every
    rank holds the same sum. The block shrinks to the per-rank tile for
    a small array; tiles are block multiples, so a caller's block
    boundary (one table row) is never straddled. Returns ``(sum, new
    residual)`` in ``x``'s shape."""
    n = cg.size
    size = x.numel()
    block = min(block, max(1, -(-size // n)))
    tile = -(-size // (n * block)) * block
    flat = torch.nn.functional.pad(x.reshape(-1), (0, n * tile - size))
    res_flat = None
    if residual is not None:
        res_flat = torch.nn.functional.pad(residual.reshape(-1),
                                           (0, n * tile - size))
    local, new_res = quantized_psum_scatter(flat, cg, gen, residual=res_flat,
                                            block=block, dtype=dtype, u=u)
    full = all_gather_tiled(local, cg)[:size].reshape(x.shape)
    return full, new_res[:size].reshape(x.shape)


def quantized_all_gather(x: torch.Tensor, cg, gen=None,
                         residual: Optional[torch.Tensor] = None,
                         block: int = DEFAULT_QUANT_BLOCK,
                         dtype: str = "int8",
                         u: Optional[torch.Tensor] = None):
    """Error-feedback quantized all-gather over dim 0 (the downlink): each
    rank quantizes its tile plus its carried remainder, the payloads and
    scales are gathered, and every rank dequantizes the ``n`` tiles.
    Returns ``(the concatenated quantized tiles, this rank's new
    residual)``; the gathered array is the same on every rank."""
    n = cg.size
    if residual is not None:
        x = x + residual
    shape = tuple(x.shape)
    elems = x.numel()
    nbd = -(-elems // block)
    xb = torch.nn.functional.pad(x.reshape(-1),
                                 (0, nbd * block - elems)).reshape(nbd, block)
    q, scale = quantize_blocks(xb, _uniforms(xb.shape, x, gen, u), dtype)
    new_residual = (xb - dequantize_blocks(q, scale, dtype, block)) \
        .reshape(-1)[:elems].reshape(shape)
    q_all = _unwire(all_gather_tiled(_wire(q, dtype), cg), dtype)
    s_all = all_gather_tiled(scale, cg)
    full = dequantize_blocks(q_all, s_all, dtype, block)
    full = full.reshape(n, nbd * block)[:, :elems] \
        .reshape((n * shape[0],) + shape[1:])
    return full, new_residual


# --------------------------------------------------------------------------
# per-axis hierarchical collectives (the 2-D grid)
# --------------------------------------------------------------------------

def _level(seq, lvl):
    return None if seq is None else seq[lvl]


def hierarchical_psum_scatter(x: torch.Tensor, lowering, cg, gens=None,
                              residuals=None,
                              block: int = DEFAULT_QUANT_BLOCK, u=None):
    """Level-by-level reduce-scatter over an ordered ``((axis, dtype),
    ...)`` lowering (``resolve_leg_lowering``) on the grid ``cg``, each
    level over this rank's group along its axis (``cg.axis``), at its own
    wire dtype and with its own error-feedback carry. Reducing level by
    level in the tuple order tiles as the flat tuple collective does
    (both first-name-major). ``gens``, ``residuals`` and ``u`` (the
    uniforms of ``quantized_psum_scatter``) are aligned with the lowering,
    None at float32 levels; a level-``j`` carry has the shape of that
    level's input (the tile shrinks by each reduced axis). Returns
    ``(this rank's tile of the sum, new carries)``, the carries a tuple
    aligned with the lowering (None at float32 levels)."""
    new_residuals = []
    t = x
    for lvl, (ax, dt) in enumerate(lowering):
        g = cg.axis(ax)
        if dt == "float32":
            t = reduce_scatter_sum(t, g)
            new_residuals.append(None)
        else:
            t, nr = quantized_psum_scatter(
                t, g, _level(gens, lvl), residual=_level(residuals, lvl),
                block=block, dtype=dt, u=_level(u, lvl))
            new_residuals.append(nr)
    return t, tuple(new_residuals)


def hierarchical_psum(x: torch.Tensor, lowering, cg, gens=None,
                      residuals=None, block: int = DEFAULT_QUANT_BLOCK,
                      u=None):
    """Level-by-level all-reduce over an ordered lowering: the table
    leg's hierarchical form. Each level runs the exact all-reduce
    (float32) or ``quantized_psum`` with its own carry, ``x``-shaped at
    every level. Returns ``(sum, new carries)``."""
    new_residuals = []
    t = x
    for lvl, (ax, dt) in enumerate(lowering):
        g = cg.axis(ax)
        if dt == "float32":
            t = all_reduce_sum(t.clone(), g)
            new_residuals.append(None)
        else:
            t, nr = quantized_psum(
                t, g, _level(gens, lvl), residual=_level(residuals, lvl),
                block=block, dtype=dt, u=_level(u, lvl))
            new_residuals.append(nr)
    return t, tuple(new_residuals)


def hierarchical_all_gather(x: torch.Tensor, lowering, cg, gens=None,
                            residuals=None,
                            block: int = DEFAULT_QUANT_BLOCK, u=None):
    """Level-by-level all-gather over an ordered lowering, in REVERSE
    level order (the last-reduced axis gathers first), which reassembles
    the tiling ``hierarchical_psum_scatter`` made. Carry slot ``j`` stays
    aligned with level ``j``: it has the shape of level ``j``'s gather
    input, and ranks along the axes already gathered hold the same data
    there and draw the same uniforms (``level_sr_generators`` keys on the
    level's own axis index), so the slot is replicated over them.
    Returns ``(gathered, new carries)``."""
    new_residuals = [None] * len(lowering)
    t = x
    for lvl in reversed(range(len(lowering))):
        ax, dt = lowering[lvl]
        g = cg.axis(ax)
        if dt == "float32":
            t = all_gather_tiled(t, g)
        else:
            t, nr = quantized_all_gather(
                t, g, _level(gens, lvl), residual=_level(residuals, lvl),
                block=block, dtype=dt, u=_level(u, lvl))
            new_residuals[lvl] = nr
    return t, tuple(new_residuals)


# --------------------------------------------------------------------------
# the per-leg plan
# --------------------------------------------------------------------------

def _norm_dtype(dt: str) -> str:
    dt = dt.strip()
    return {"fp32": "float32", "fp8": "fp8_e4m3"}.get(dt, dt)


def leg_axis_entries(value: str):
    """One leg value's per-axis form, ``axis:dtype`` pairs joined by
    ``/`` (``ici:fp32/dcn:int8``), as ``[(token, dtype), ...]`` with the
    dtypes in ``WIRE_DTYPES`` spelling; None for a plain dtype. Raises
    ``ValueError`` on a malformed pair, an unknown dtype or a token named
    twice (the checks against the grid are ``resolve_leg_lowering``'s)."""
    if ":" not in value:
        return None
    entries = []
    seen = set()
    for part in value.split("/"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"collective plan per-axis entry {part!r}: expected "
                f"axis:dtype (e.g. dcn:int8)")
        tok, dt = part.split(":", 1)
        tok = tok.strip()
        dt = _norm_dtype(dt)
        if not tok:
            raise ValueError(
                f"collective plan per-axis entry {part!r}: empty axis name")
        if dt not in WIRE_DTYPES:
            raise ValueError(
                f"collective plan per-axis dtype {dt!r}: choose from "
                f"{WIRE_DTYPES}")
        if tok in seen:
            raise ValueError(
                f"collective plan names axis {tok!r} twice in one leg")
        seen.add(tok)
        entries.append((tok, dt))
    if not entries:
        raise ValueError(f"collective plan leg {value!r}: no axis:dtype "
                         f"entries")
    return entries


def leg_quantized(value) -> bool:
    """True iff the leg moves any bytes that are not float32 (a lowering
    tuple, or a per-axis value with a quantized entry)."""
    if isinstance(value, tuple):
        return any(dt != "float32" for _, dt in value)
    entries = leg_axis_entries(value)
    if entries is None:
        return value != "float32"
    return any(dt != "float32" for _, dt in entries)


def resolve_leg_lowering(value: str, axis_order, placement: dict):
    """One leg value resolved against the grid: a plain dtype is itself; a
    per-axis value is an ordered ``((axis, dtype), ...)`` lowering over
    ``axis_order`` (the server reduce axes, a name or an ordered tuple).
    A token is an axis of ``axis_order`` or a placement alias (``ici`` /
    ``dcn``: every reduce axis with that placement). Axes no entry covers
    stay float32. A token that matches no axis raises ``ValueError``
    naming the axes and their placements. When every axis lands on one
    dtype the leg collapses to that plain dtype: the flat tuple
    collective over the same order is the same sum, in one hop."""
    entries = leg_axis_entries(value)
    if entries is None:
        return value
    axes = (axis_order,) if isinstance(axis_order, str) else tuple(axis_order)
    resolved = {}
    for tok, dt in entries:
        if tok in axes:
            targets = [tok]
        elif tok in PLACEMENT_ALIASES:
            targets = [a for a in axes if placement.get(a) == tok]
            if not targets:
                raise ValueError(
                    f"collective plan entry {tok}:{dt} resolves to no mesh "
                    f"axis: no server reduce axis has {tok!r} placement "
                    f"(axes: " + ", ".join(
                        f"{a}={placement.get(a, '?')}" for a in axes) + ")")
        else:
            raise ValueError(
                f"collective plan entry names mesh axis {tok!r} which the "
                f"resolved mesh does not have (server reduce axes: "
                + ", ".join(f"{a}={placement.get(a, '?')}" for a in axes)
                + f"; placement aliases: {'/'.join(PLACEMENT_ALIASES)})")
        for a in targets:
            if a in resolved:
                raise ValueError(
                    f"collective plan covers mesh axis {a!r} twice "
                    f"(entry {tok}:{dt} overlaps an earlier entry)")
            resolved[a] = dt
    lowering = tuple((a, resolved.get(a, "float32")) for a in axes)
    dtypes = {dt for _, dt in lowering}
    if len(dtypes) == 1:
        return next(iter(dtypes))
    return lowering


@dataclass(frozen=True)
class CollectivePlan:
    """Wire dtype of each leg; ``float32`` legs run the exact
    collectives. A leg may hold a per-axis value (``ici:fp32/dcn:int8``,
    ``leg_axis_entries``'s grammar), which lowers hierarchically on the
    2-D grid (``resolve_leg_lowering``) with one carry a level."""

    uplink: str = "float32"
    table: str = "float32"
    downlink: str = "float32"

    def __post_init__(self):
        for leg in PLAN_LEGS:
            dt = getattr(self, leg)
            if ":" in dt:
                leg_axis_entries(dt)  # the grammar; raises ValueError
                continue
            assert dt in WIRE_DTYPES, \
                f"collective plan leg {leg}={dt!r}: choose from " \
                f"{WIRE_DTYPES} or per-axis axis:dtype pairs"

    @property
    def quantized(self) -> bool:
        return any(leg_quantized(getattr(self, leg)) for leg in PLAN_LEGS)

    @property
    def per_axis(self) -> bool:
        """True iff a leg holds a per-axis value."""
        return any(":" in getattr(self, leg) for leg in PLAN_LEGS)

    def spec(self) -> str:
        return ",".join(f"{leg}={getattr(self, leg)}" for leg in PLAN_LEGS)


FP32_PLAN = CollectivePlan()


def parse_collective_plan(spec: Optional[str]) -> CollectivePlan:
    """``--collective_plan`` -> ``CollectivePlan``: empty/None is the fp32
    plan; one bare dtype sets every leg; comma-separated ``leg=dtype``
    pairs set those legs (unnamed legs stay float32). ``fp32`` spells
    ``float32`` and ``fp8`` ``fp8_e4m3``. A leg's dtype may be per axis
    (``uplink=ici:fp32/dcn:int8``; a bare per-axis value sets every leg);
    the axes are checked against the grid by ``resolve_leg_lowering``.
    ``auto`` is resolved by ``autotune_collective_plan``, not here."""
    if not spec:
        return FP32_PLAN
    spec = spec.strip()
    assert spec != "auto", \
        "resolve --collective_plan auto via autotune_collective_plan " \
        "before parsing"

    def norm(dt):
        dt = dt.strip()
        if ":" in dt:
            # the per-axis form: normalize each pair's dtype
            return "/".join(f"{tok}:{d}" for tok, d in leg_axis_entries(dt))
        dt = _norm_dtype(dt)
        assert dt in WIRE_DTYPES, \
            f"collective plan dtype {dt!r}: choose from {WIRE_DTYPES}"
        return dt

    if "=" not in spec:
        dt = norm(spec)
        return CollectivePlan(uplink=dt, table=dt, downlink=dt)
    kv = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        assert "=" in part, \
            f"collective plan entry {part!r}: expected leg=dtype"
        leg, dt = part.split("=", 1)
        leg = leg.strip()
        assert leg in PLAN_LEGS, \
            f"collective plan leg {leg!r}: choose from {PLAN_LEGS}"
        assert leg not in kv, f"collective plan names leg {leg!r} twice"
        kv[leg] = norm(dt)
    return CollectivePlan(**{leg: kv.get(leg, "float32")
                             for leg in PLAN_LEGS})


def plan_from_reduce_dtype(reduce_dtype: str) -> CollectivePlan:
    """The legacy ``--reduce_dtype`` alias: ``int8`` quantizes every
    leg."""
    assert reduce_dtype in ("float32", "int8"), reduce_dtype
    if reduce_dtype == "int8":
        return CollectivePlan(uplink="int8", table="int8", downlink="int8")
    return FP32_PLAN


def plan_lowering(plan: Optional[CollectivePlan], cg):
    """``{leg: resolve_leg_lowering(...)}`` of a per-axis plan on the grid
    ``cg`` (a ``ClientGroup``: its server reduce axes and their
    placement); None for a flat plan, whose legs are their dtypes."""
    if plan is None or not plan.per_axis:
        return None
    assert cg is not None, \
        "a per-axis collective plan needs the client grid (--server_shard)"
    return {leg: resolve_leg_lowering(getattr(plan, leg), cg.server_axes,
                                      cg.axis_placement())
            for leg in PLAN_LEGS}


def level_sr_generators(seed: int, round_no: int, leg: str, lowering, cg,
                        device):
    """The stochastic-rounding generators of a leg: one for a flat
    quantized leg (keyed on this rank's index ``cg.rank``), or one a
    quantized level of a lowering tuple, keyed on ``(seed, round, leg,
    level, this rank's index along the level's axis)`` (None at float32
    levels); None for a float32 leg."""
    if isinstance(lowering, tuple):
        return tuple(
            None if dt == "float32" else
            sr_generator(seed, round_no, cg.axis(ax).rank, f"{leg}.{lvl}",
                         device)
            for lvl, (ax, dt) in enumerate(lowering))
    if lowering == "float32":
        return None
    return sr_generator(seed, round_no, cg.rank if cg is not None else 0,
                        leg, device)


def _round_trip_ms(fn, x: torch.Tensor, reps: int = 3) -> float:
    """The best of ``reps`` calls of ``fn(x)`` after one warm-up, in ms:
    CUDA events on the card, the host clock on the CPU."""
    fn(x)
    best = float("inf")
    for _ in range(reps):
        if x.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(x)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn(x)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def autotune_collective_plan(leg_geoms, error_budget: float = 0.05,
                             seed: int = 0, sample_cap: int = 1 << 20,
                             candidates=QUANT_DTYPES, device="cpu",
                             u: Optional[dict] = None):
    """``--collective_plan auto``: the JAX package's probe, which picks the
    cheapest wire dtype a leg within an error budget.

    ``leg_geoms``: ``{leg: (elements, block)}`` of the legs the config
    runs (absent legs are float32). A leg's calibration transmit is the
    JAX package's, ``np.random.RandomState(seed).randn(nb, block)`` with
    ``nb = max(1, min(elements, sample_cap) // block)``; each candidate's
    quantize -> dequantize round trip is timed (``_round_trip_ms``) and
    its relative L2 error measured. A candidate is admissible iff its
    error is within ``error_budget``; among the admissible ones (float32
    always is, at error 0) the fewest ``payload_bytes`` win, ties broken
    by the lower error. The uniforms are drawn from a generator seeded
    with ``seed``, or taken from ``u[leg]`` (``(nb, block)``: a test
    passes the JAX package's).

    Returns ``(plan, report)``, ``report[leg][dtype]`` holding
    ``{"rel_err", "probe_ms", "bytes_per_round"}`` (or ``{"error"}`` for a
    candidate that failed to run), the JAX package's schema."""
    device = torch.device(device)
    report = {}
    chosen = {}
    for leg in PLAN_LEGS:
        geom = leg_geoms.get(leg)
        if geom is None:
            chosen[leg] = "float32"
            continue
        elems, block = geom
        elems = int(elems)
        block = int(min(block or DEFAULT_QUANT_BLOCK, max(1, elems)))
        n_elem = min(elems, int(sample_cap))
        nb = max(1, n_elem // block)
        cal = torch.from_numpy(np.random.RandomState(seed).randn(
            nb, block).astype(np.float32)).to(device)
        cal_norm = float(torch.sqrt(torch.sum(torch.square(cal))))
        if u is not None and u.get(leg) is not None:
            uni = torch.as_tensor(np.array(u[leg], np.float32)).to(device)
        else:
            gen = torch.Generator(device=device).manual_seed(int(seed))
            uni = torch.rand(cal.shape, generator=gen, dtype=torch.float32,
                             device=device)
        rows = {"float32": {"rel_err": 0.0, "probe_ms": 0.0,
                            "bytes_per_round": payload_bytes(
                                elems, "float32", block)}}
        best = ("float32", rows["float32"]["bytes_per_round"], 0.0)
        for dt in candidates:
            bytes_ = payload_bytes(elems, dt, block)

            def rt(x, dt=dt):
                q, s = quantize_blocks(x, uni, dt)
                return dequantize_blocks(q, s, dt, block)

            try:
                y = rt(cal)
                probe_ms = _round_trip_ms(rt, cal)
            except RuntimeError as e:  # a device without the dtype
                rows[dt] = {"error": f"{type(e).__name__}: {str(e)[:120]}"}
                continue
            rel = float(torch.sqrt(torch.sum(torch.square(cal - y)))) \
                / max(cal_norm, 1e-30)
            rows[dt] = {"rel_err": round(rel, 6),
                        "probe_ms": round(probe_ms, 3),
                        "bytes_per_round": bytes_}
            if rel <= error_budget and (
                    bytes_ < best[1]
                    or (bytes_ == best[1] and rel < best[2])):
                best = (dt, bytes_, rel)
        chosen[leg] = best[0]
        report[leg] = rows
    return CollectivePlan(**chosen), report
