"""Count-sketch compression: the port of ``commefficient_tpu/ops/sketch.py``.

Hash family (identical to the JAX package, bit for bit): the coordinate
space is split into ``T = ceil(d / c_pad)`` contiguous chunks of the
lane-aligned table width ``c_pad``; chunk ``t`` maps into row ``j`` by a
full cyclic shift,

    bucket_j(i) = (pos(i) + m[j, t]) mod c_pad ,     pos(i) = i mod c_pad

with ``m`` drawn from a seeded numpy ``RandomState`` in the same calls and
order as the JAX package, and per-(row, coordinate) signs from the murmur3
fmix32 finalizer of ``idx ^ key_j``.

Four operations carry the round, each with a CUDA kernel for the H100
(``commefficient_torch/csrc/``) and a plain PyTorch version in this module:

- ``sketch_accumulate``: ``(Tn, S, 128)`` chunks -> ``(r, S, 128)`` table,
  the per-cell adds in chunk order from a zero table (the JAX ``lax.scan``
  fold), so kernel and plain version agree bit for bit;
- ``sketch_accumulate_into``: the same adds, each cell starting from an
  incoming table (the streaming client phase's running table:
  ``sketch_chunks_accum``), and its segment form ``sketch_segment_into``
  (``sketch_segment_accum``, ``sketch_segments_accum``), where the kernel
  reads a group's flat vector in place and the plain version pads it to
  its covering chunks;
- ``sketch_estimates``: the median-of-rows query, ``(r, S, 128)`` table ->
  ``(Tn, S, 128)`` estimates, the positions at and past a global
  coordinate ``n_valid`` (the padded tail, for ``estimates_chunks``)
  masked to +0.0 by the kernel itself;
- ``fused_epilogue``: the server's threshold mask, update and re-sketch
  of that update in one sweep (``--fused_epilogue``).

Dispatch rule of all four: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel (which raises on what it cannot take). There is no
fallback from a kernel to its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from commefficient_torch.ops.flat import LANES, ChunkLayout
from commefficient_torch.ops.topk import (
    _apply_threshold,
    resolve_threshold,
    topk_dense_nd,
)

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class CountSketch:
    """Hash geometry for a count-sketch: int32 tensors on one device plus
    the static ints."""

    shift_q: torch.Tensor    # (r, T) int32, sublane part of the forward shift
    shift_w: torch.Tensor    # (r, T) int32, lane part of the forward shift
    inv_q: torch.Tensor      # (r, T) int32, sublane part of the inverse shift
    inv_w: torch.Tensor      # (r, T) int32, lane part of the inverse shift
    sign_keys: torch.Tensor  # (r,) int32 per-row sign-hash keys
    d: int
    c: int       # requested columns
    c_pad: int   # lane-aligned columns
    r: int
    T: int       # number of chunks
    num_blocks: int

    @property
    def table_shape(self):
        return (self.r, self.c_pad)

    @property
    def sublanes(self):
        return self.c_pad // LANES

    @property
    def chunk_layout(self) -> ChunkLayout:
        return ChunkLayout(d=self.d, T=self.T, S=self.sublanes)

    @property
    def device(self) -> torch.device:
        return self.sign_keys.device


def make_sketch(d: int, c: int, r: int, seed: int = 42, num_blocks: int = 20,
                device="cuda") -> CountSketch:
    """Sketch geometry, deterministic in ``seed``: the same
    ``RandomState`` calls in the same order as the JAX package (shifts
    ``(r, T)`` first, then the keys), so both draw the same geometry."""
    c_pad = -(-int(c) // LANES) * LANES
    T = max(1, -(-int(d) // c_pad))
    rng = np.random.RandomState(seed)
    m = rng.randint(0, c_pad, size=(r, T))
    inv = (-m) % c_pad
    keys = rng.randint(1, 2**31 - 1, size=(r,))

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return CountSketch(
        shift_q=i32(m // LANES), shift_w=i32(m % LANES),
        inv_q=i32(inv // LANES), inv_w=i32(inv % LANES),
        sign_keys=i32(keys), d=int(d), c=int(c), c_pad=int(c_pad), r=int(r),
        T=int(T), num_blocks=int(num_blocks))


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32), split in 16-bit
    halves of ``m`` so no int64 product overflows."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over uint32 values held in int64 (the JAX version's
    logical shifts and wrapping multiplies, on the same bits)."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _signs_for(idx: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """+-1 float32 sign hash of int coordinate indices under int32 keys."""
    h = _mix32((idx.to(torch.int64) ^ key.to(torch.int64)) & _U32)
    return (h & 1).to(torch.float32) * 2.0 - 1.0


def _median_small(rows):
    """Elementwise median of a static-length list via the min/max bubble
    network of the JAX package (NaN-propagating ``torch.minimum`` /
    ``torch.maximum``; even length averages the middle two)."""
    arr = list(rows)
    n = len(arr)
    for i in range(n):
        for j in range(n - 1 - i):
            lo = torch.minimum(arr[j], arr[j + 1])
            hi = torch.maximum(arr[j], arr[j + 1])
            arr[j], arr[j + 1] = lo, hi
    if n % 2:
        return arr[n // 2]
    return 0.5 * (arr[n // 2 - 1] + arr[n // 2])


def _chunks3(cs: CountSketch, v: torch.Tensor) -> torch.Tensor:
    """Pad ``(d,)`` -> ``(T, S, 128)`` chunk/sublane/lane layout."""
    return cs.chunk_layout.chunk(v.to(torch.float32))


def _shift_cols(q: torch.Tensor, w: torch.Tensor, t0: int, Tn: int):
    """Columns ``[t0, t0+Tn)`` of the ``(r, T)`` shift arrays, zero-padded
    past T (chunks past T must be all-zero input; their outputs are
    tail-masked by the caller)."""
    r, T = q.shape
    qp = torch.zeros((r, t0 + Tn), dtype=q.dtype, device=q.device)
    wp = torch.zeros_like(qp)
    n = max(0, min(T, t0 + Tn) - t0)
    qp[:, t0:t0 + n] = q[:, t0:t0 + n]
    wp[:, t0:t0 + n] = w[:, t0:t0 + n]
    return qp[:, t0:].contiguous(), wp[:, t0:].contiguous()


# --------------------------------------------------------------------------
# accumulate: (Tn, S, 128) chunks -> (r, S, 128) table
# --------------------------------------------------------------------------

def _sketch_accumulate_into_plain(tbl3, v3, shift_q, shift_w, sign_keys,
                                  t0: int = 0):
    """Plain PyTorch running-table accumulate (a transcription of
    ``_sketch_accum_chunks_jax``): chunk t lands in row j at
    ``table[j, c] += sign * v3[t, (c - m) mod c_pad]``, chunks added in t
    order onto the incoming ``(r, S, 128)`` table."""
    Tn, S, _ = v3.shape
    c_pad = S * LANES
    r = shift_q.shape[0]
    dev = v3.device
    pos = torch.arange(c_pad, device=dev, dtype=torch.int64)
    m = shift_q.to(torch.int64) * LANES + shift_w.to(torch.int64)  # (r, Tn)
    keys = sign_keys.reshape(r, 1)
    table = tbl3.reshape(r, c_pad)
    for t in range(Tn):
        signs = _signs_for((t0 + t) * c_pad + pos[None, :], keys)  # (r, c_pad)
        sv = v3[t].reshape(1, c_pad) * signs
        src = (pos[None, :] - m[:, t:t + 1]) % c_pad
        table = table + torch.gather(sv, 1, src)
    return table.view(r, S, LANES)


def _sketch_accumulate_plain(v3, shift_q, shift_w, sign_keys, t0: int = 0):
    """Plain PyTorch accumulate (a transcription of ``_sketch_chunks_jax``):
    the running-table accumulate onto a zero table."""
    zero = torch.zeros((shift_q.shape[0],) + tuple(v3.shape[1:]),
                       dtype=torch.float32, device=v3.device)
    return _sketch_accumulate_into_plain(zero, v3, shift_q, shift_w,
                                         sign_keys, t0)


def sketch_accumulate(v3: torch.Tensor, shift_q: torch.Tensor,
                      shift_w: torch.Tensor, sign_keys: torch.Tensor,
                      t0: int = 0) -> torch.Tensor:
    """The accumulate (``_sketch_vec_pallas``'s contract): ``v3`` holds
    ``Tn`` chunks starting at global chunk ``t0``; ``shift_q``/``shift_w``
    are that range's ``(r, Tn)`` shift columns. Returns ``(r, S, 128)``."""
    if v3.device.type == "cpu":
        return _sketch_accumulate_plain(v3, shift_q, shift_w, sign_keys, t0)
    from commefficient_torch import kernels

    return kernels.sketch_accumulate(v3, shift_q, shift_w, sign_keys, t0)


def sketch_chunks(cs: CountSketch, v3: torch.Tensor,
                  t0: Optional[int] = None) -> torch.Tensor:
    """Accumulate a vector in the ``(T, S, 128)`` resident chunk layout
    (zero tail) into an ``(r, c_pad)`` table. With ``t0``, ``v3`` holds
    ``Tn`` chunks from global chunk ``t0`` and the result is that range's
    partial table (linearity: the partials sum to the full table)."""
    Tn = v3.shape[0]
    assert tuple(v3.shape[1:]) == (cs.sublanes, LANES), tuple(v3.shape)
    if t0 is None:
        assert Tn == cs.T, (Tn, cs.T)
        q, w, t0 = cs.shift_q, cs.shift_w, 0
    else:
        q, w = _shift_cols(cs.shift_q, cs.shift_w, int(t0), Tn)
    out = sketch_accumulate(v3.contiguous(), q, w, cs.sign_keys, int(t0))
    return out.view(cs.r, cs.c_pad)


def sketch_chunks_local(cs: CountSketch, v3: torch.Tensor,
                        t0: int) -> torch.Tensor:
    """The partial ``(r, c_pad)`` table of ``Tn`` chunks from global chunk
    ``t0`` (the sharded server's re-sketch of its update slice). Chunks
    past ``T`` must be zero; their shift columns are zero padding. The sum
    of the ranks' partials equals ``sketch_chunks`` up to float32
    summation order, so the server reads it for its zero pattern only."""
    return sketch_chunks(cs, v3, t0=int(t0))


def sketch_vec(cs: CountSketch, v: torch.Tensor) -> torch.Tensor:
    """Accumulate a dense ``(d,)`` vector into an ``(r, c_pad)`` table."""
    return sketch_chunks(cs, _chunks3(cs, v))


# --------------------------------------------------------------------------
# running-table accumulate: table + the sketch of a chunk range
# --------------------------------------------------------------------------

def sketch_accumulate_into(tbl3: torch.Tensor, v3: torch.Tensor,
                           shift_q: torch.Tensor, shift_w: torch.Tensor,
                           sign_keys: torch.Tensor,
                           t0: int = 0) -> torch.Tensor:
    """The running-table accumulate (``_accum_pallas_call``'s contract):
    ``tbl3`` is the incoming ``(r, S, 128)`` table, ``v3`` holds ``Tn``
    chunks from global chunk ``t0`` and ``shift_q``/``shift_w`` are that
    range's ``(r, Tn)`` shift columns. Per cell the adds are ``((tbl + c_0)
    + c_1) + ...`` in chunk order, continuing the incoming table's fold.
    Returns a new ``(r, S, 128)`` table."""
    if v3.device.type == "cpu":
        return _sketch_accumulate_into_plain(tbl3, v3, shift_q, shift_w,
                                             sign_keys, t0)
    from commefficient_torch import kernels

    return kernels.sketch_accumulate_into(tbl3, v3, shift_q, shift_w,
                                          sign_keys, t0)


def _segment_range(cs: CountSketch, e0: int, n: int):
    """The chunks ``[t_a, t_a + Tn)`` that coordinates ``[e0, e0 + n)``
    touch, and ``lpad``, the position of ``e0`` in chunk ``t_a``:
    ``(t_a, lpad, Tn)``."""
    t_a = e0 // cs.c_pad
    lpad = e0 - t_a * cs.c_pad
    return t_a, lpad, -(-(lpad + n) // cs.c_pad)


def _segment_chunks(cs: CountSketch, seg: torch.Tensor, e0: int):
    """Zero-pad a 1-D segment holding coordinates ``[e0, e0 + n)`` out to
    the chunk boundaries it touches: ``((Tn, S, 128) chunks, t_a)`` for the
    chunks ``[t_a, t_a + Tn)``. The buffer is segment-sized (at most two
    chunks more), never d-sized. Pad positions add ``sign * 0`` to their
    cells, so a cell whose every contribution is zero may differ from the
    composed sketch in the sign of its zero, never under ``==``."""
    n = int(seg.numel())
    t_a, lpad, Tn = _segment_range(cs, e0, n)
    v = seg.new_zeros(Tn * cs.c_pad, dtype=torch.float32)
    v[lpad:lpad + n] = seg.reshape(-1)
    return v.view(Tn, cs.sublanes, LANES), t_a


def _sketch_segment_into_plain(cs: CountSketch, table: torch.Tensor,
                               seg: torch.Tensor, e0: int) -> torch.Tensor:
    """Plain segment accumulate: ``_segment_chunks`` then the plain running
    accumulate of the covering chunk range."""
    v3, t_a = _segment_chunks(cs, seg, e0)
    t_b = t_a + v3.shape[0]
    out = _sketch_accumulate_into_plain(
        table.reshape(cs.r, cs.sublanes, LANES), v3,
        cs.shift_q[:, t_a:t_b], cs.shift_w[:, t_a:t_b], cs.sign_keys, t_a)
    return out.reshape(cs.r, cs.c_pad)


def sketch_segment_into(cs: CountSketch, table: torch.Tensor,
                        seg: torch.Tensor, e0: int) -> torch.Tensor:
    """``table`` plus the sketch of a non-empty flat segment holding
    coordinates ``[e0, e0 + n)``, per cell in chunk order over the chunks
    the segment touches, their positions outside it adding ``sign * 0``.
    The kernel reads the segment in place; the plain version pads it
    (``_segment_chunks``). Both give the same bits."""
    if seg.device.type == "cpu":
        return _sketch_segment_into_plain(cs, table, seg, e0)
    from commefficient_torch import kernels

    t_a, lpad, Tn = _segment_range(cs, e0, int(seg.numel()))
    t_b = t_a + Tn
    out = kernels.sketch_segment_into(
        table.reshape(cs.r, cs.sublanes, LANES).contiguous(),
        seg.reshape(-1).contiguous(), lpad,
        cs.shift_q[:, t_a:t_b].contiguous(),
        cs.shift_w[:, t_a:t_b].contiguous(), cs.sign_keys, t_a)
    return out.view(cs.r, cs.c_pad)


def sketch_segment_accum(cs: CountSketch, table: torch.Tensor,
                         seg: torch.Tensor, e0: int) -> torch.Tensor:
    """Accumulate a contiguous segment (coordinates ``[e0, e0 +
    seg.numel())`` of the d-vector) into a running ``(r, c_pad)`` table.
    Streaming a vector through consecutive segments in offset order equals
    ``sketch_vec`` of the whole vector under ``==`` (``_segment_chunks``)."""
    e0 = int(e0)
    n = int(seg.numel())
    assert 0 <= e0 and e0 + n <= cs.d, (e0, n, cs.d)
    assert tuple(table.shape) == cs.table_shape, (tuple(table.shape),
                                                   cs.table_shape)
    if n == 0:
        return table
    return sketch_segment_into(cs, table, seg, e0)


# staging ceiling of the coalescer's auto budget
_COALESCE_MAX_BUDGET = 32 * 1024 * 1024


def coalesce_vmem_budget(cs: CountSketch) -> int:
    """Auto group-sizing budget (bytes) for ``ops/flat.coalesce_segments``
    (``--sketch_coalesce``), the JAX package's rule under its name:
    ``min(32 MiB, max(one chunk, padded plane / 4))``. On this card it
    bounds a group's concatenated leaves, which the kernel reads in place
    (it keeps nothing group-sized on chip), so a group copies at most a
    quarter of the d-plane (3 chunks, 6 MB, at the headline geometry)."""
    chunk_bytes = cs.c_pad * 4
    padded = cs.T * chunk_bytes
    return int(min(_COALESCE_MAX_BUDGET, max(chunk_bytes, padded // 4)))


def sketch_segments_accum(cs: CountSketch, table: torch.Tensor,
                          segs: Sequence[torch.Tensor],
                          e0: int) -> torch.Tensor:
    """One launch for a group of contiguous segments: segment ``i`` starts
    where ``i - 1`` ends and the first starts at flat offset ``e0``
    (``ops/flat.coalesce_segments`` plans the groups). Per cell the adds
    replay the per-segment fold in the same chunk order, with fewer ``+-0``
    terms at shared boundary chunks, so it equals folding
    ``sketch_segment_accum`` over the segments under ``==``. Zero-size
    segments are skipped."""
    e0 = int(e0)
    xs = [x.reshape(-1) for x in segs if x.numel()]
    n = sum(int(x.numel()) for x in xs)
    assert tuple(table.shape) == cs.table_shape, (tuple(table.shape),
                                                   cs.table_shape)
    if n == 0:
        return table
    assert 0 <= e0 and e0 + n <= cs.d, (e0, n, cs.d)
    v = xs[0] if len(xs) == 1 else torch.cat(xs)
    return sketch_segment_into(cs, table, v, e0)


def sketch_chunks_accum(cs: CountSketch, table: torch.Tensor,
                        v3: torch.Tensor) -> torch.Tensor:
    """Full-range running-table accumulate: ``table`` plus the sketch of a
    vector in the ``(T, S, 128)`` resident layout (the streaming client
    phase's weight-decay term)."""
    assert tuple(v3.shape) == (cs.T, cs.sublanes, LANES), tuple(v3.shape)
    assert tuple(table.shape) == cs.table_shape, (tuple(table.shape),
                                                   cs.table_shape)
    out = sketch_accumulate_into(
        table.reshape(cs.r, cs.sublanes, LANES).contiguous(),
        v3.contiguous(), cs.shift_q, cs.shift_w, cs.sign_keys, 0)
    return out.view(cs.r, cs.c_pad)


# --------------------------------------------------------------------------
# query: (r, S, 128) table -> (Tn, S, 128) estimates
# --------------------------------------------------------------------------

def _sketch_estimates_plain(table3, inv_q, inv_w, sign_keys, t0: int = 0):
    """Plain PyTorch query (a transcription of ``_estimates_chunks_jax``):
    each row rolled by the INVERSE shift, times the chunk's signs, median
    over rows. ``inv_q``/``inv_w`` are the ``(r, Tn)`` inverse-shift
    columns of the chunk range."""
    r, S, _ = table3.shape
    c_pad = S * LANES
    Tn = inv_q.shape[1]
    dev = table3.device
    rows = table3.reshape(r, c_pad)
    pos = torch.arange(c_pad, device=dev, dtype=torch.int64)
    inv = inv_q.to(torch.int64) * LANES + inv_w.to(torch.int64)  # (r, Tn)
    keys = sign_keys.reshape(r, 1)
    out = []
    for t in range(Tn):
        # roll by inv: rolled[p] = row[(p - inv) mod c_pad]
        src = (pos[None, :] - inv[:, t:t + 1]) % c_pad
        rolled = torch.gather(rows, 1, src)
        est = rolled * _signs_for((t0 + t) * c_pad + pos[None, :], keys)
        out.append(_median_small([est[i] for i in range(r)]))
    return torch.stack(out).view(Tn, S, LANES)


def _mask_from(est3: torch.Tensor, t0: int, n_valid: int) -> torch.Tensor:
    """``mask_tail`` by global coordinate: the positions of the chunks
    from ``t0`` whose coordinate is ``>= n_valid`` set to +0.0."""
    Tn, S, _ = est3.shape
    c_pad = S * LANES
    n = min(max(n_valid - t0 * c_pad, 0), Tn * c_pad)
    return ChunkLayout(d=n, T=Tn, S=S).mask_tail(est3)


def sketch_estimates(table3: torch.Tensor, cs: CountSketch,
                     t0: int = 0, Tn: Optional[int] = None,
                     n_valid: Optional[int] = None) -> torch.Tensor:
    """The median-of-rows query (``_estimates_pallas``'s contract):
    estimates of the ``Tn`` chunks from global chunk ``t0`` as
    ``(Tn, S, 128)``. Positions whose global coordinate is ``>= n_valid``
    are +0.0; with ``n_valid=None`` the padded tail holds hash noise. The
    kernel reads ``row_j[(p + m) mod c_pad]`` with the FORWARD shifts and
    writes the mask itself; the plain version rolls by the inverse shifts
    and masks after; both give the same values."""
    Tn = cs.T if Tn is None else Tn
    full = t0 == 0 and Tn == cs.T
    if table3.device.type == "cpu":
        iq, iw = ((cs.inv_q, cs.inv_w) if full
                  else _shift_cols(cs.inv_q, cs.inv_w, t0, Tn))
        est = _sketch_estimates_plain(table3, iq, iw, cs.sign_keys, t0)
        return est if n_valid is None else _mask_from(est, t0, n_valid)
    fq, fw = ((cs.shift_q, cs.shift_w) if full
              else _shift_cols(cs.shift_q, cs.shift_w, t0, Tn))
    from commefficient_torch import kernels

    return kernels.sketch_estimates(table3.contiguous(), fq, fw,
                                    cs.sign_keys, t0, n_valid)


def estimates_chunks(cs: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """Median-of-rows estimates in the ``(T, S, 128)`` resident layout with
    the padded tail masked to +0.0 (on the card by the query kernel, in
    the same launch)."""
    table3 = table.reshape(cs.r, cs.sublanes, LANES)
    return sketch_estimates(table3, cs, n_valid=cs.d)


def estimates_chunks_local(cs: CountSketch, table: torch.Tensor, t0: int,
                           Tn: int) -> torch.Tensor:
    """The sharded server's slice of ``estimates_chunks``: the ``Tn``
    chunks from global chunk ``t0``, per chunk the full query's values,
    every position whose global coordinate is ``>= d`` (the padded tail,
    and whole chunks past ``T`` on the last ranks of an uneven split)
    +0.0. One query launch on the card."""
    table3 = table.reshape(cs.r, cs.sublanes, LANES)
    return sketch_estimates(table3, cs, t0=int(t0), Tn=int(Tn),
                            n_valid=cs.d)


def estimates(cs: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """Median-of-rows estimate of every coordinate, ``(d,)``."""
    return cs.chunk_layout.unchunk(estimates_chunks(cs, table))


def unsketch_chunks(cs: CountSketch, table: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Top-k of the masked estimate chunks, shape-preserving (tail zero)."""
    return topk_dense_nd(estimates_chunks(cs, table), k)


def unsketch(cs: CountSketch, table: torch.Tensor, k: int) -> torch.Tensor:
    """Dense ``(d,)`` vector of the k largest-magnitude estimates."""
    return cs.chunk_layout.unchunk(unsketch_chunks(cs, table, k))


# --------------------------------------------------------------------------
# fused epilogue: estimates -> (masked update, its re-sketch)
# --------------------------------------------------------------------------

def _fused_epilogue_plain(est3, p, shift_q, shift_w, sign_keys, t0: int = 0):
    """Plain PyTorch fused epilogue: the composed pair it replaces, the
    threshold mask of ``ops/topk`` at the resolved ``p`` and the accumulate
    of the masked update."""
    upd = _apply_threshold(est3.view(torch.int32), est3, p)
    return upd, _sketch_accumulate_plain(upd, shift_q, shift_w, sign_keys,
                                         t0)


def fused_epilogue(est3: torch.Tensor, p: torch.Tensor,
                   shift_q: torch.Tensor, shift_w: torch.Tensor,
                   sign_keys: torch.Tensor, t0: int = 0):
    """The one-sweep server epilogue (``_fused_epilogue_pallas``'s
    contract): ``est3`` holds the ``Tn`` estimate chunks from global chunk
    ``t0``, ``p`` the int32 threshold pattern (a device tensor, never read
    on the host), ``shift_q``/``shift_w`` the range's ``(r, Tn)`` shift
    columns. Returns ``(update (Tn, S, 128), table (r, S, 128))``: the
    masked update (``|est| >= p`` on bit patterns, tie-inclusive, NaN
    passed through) and its re-sketch, bit-identical to ``topk_dense_nd``
    followed by ``sketch_accumulate`` at the same ``p``, zero signs
    included."""
    if est3.device.type == "cpu":
        return _fused_epilogue_plain(est3, p, shift_q, shift_w, sign_keys, t0)
    from commefficient_torch import kernels

    return kernels.fused_epilogue(est3, p, shift_q, shift_w, sign_keys, t0)


def fused_epilogue_chunks(cs: CountSketch, est3: torch.Tensor, k: int):
    """Fused epilogue over the full chunk range: the threshold from
    ``ops/topk.resolve_threshold``, then one epilogue call. Returns
    ``(update (T, S, 128), table (r, c_pad))``, a drop-in for
    ``upd = topk_dense_nd(est3, k); tbl = sketch_chunks(cs, upd)``."""
    est3 = est3.contiguous()
    p = resolve_threshold(est3, k)
    upd, table = fused_epilogue(est3, p, cs.shift_q, cs.shift_w,
                                cs.sign_keys, 0)
    return upd, table.view(cs.r, cs.c_pad)


def fused_epilogue_chunks_local(cs: CountSketch, est3: torch.Tensor, t0: int,
                                k: int, group):
    """The sharded server's fused epilogue over this rank's ``Tn``
    estimate chunks from global chunk ``t0``: the threshold is the global
    one (the per-pass descent over counts exchanged in ``group``), and the
    table is this rank's partial re-sketch. Per chunk the values are the
    full epilogue's."""
    est3 = est3.contiguous()
    Tn = est3.shape[0]
    p = resolve_threshold(est3, k, group)
    q, w = _shift_cols(cs.shift_q, cs.shift_w, int(t0), Tn)
    upd, table = fused_epilogue(est3, p, q, w, cs.sign_keys, int(t0))
    return upd, table.view(cs.r, cs.c_pad)


def l2estimate(table: torch.Tensor) -> torch.Tensor:
    """Median-of-rows estimate of the sketched vector's L2 norm."""
    sq = torch.sum(torch.square(table), dim=1)
    return torch.sqrt(_median_small([sq[i] for i in range(sq.shape[0])]))
