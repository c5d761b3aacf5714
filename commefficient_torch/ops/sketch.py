"""Count-sketch compression: the port of ``commefficient_tpu/ops/sketch.py``.

Hash family (identical to the JAX package, bit for bit): the coordinate
space is split into ``T = ceil(d / c_pad)`` contiguous chunks of the
lane-aligned table width ``c_pad``; chunk ``t`` maps into row ``j`` by a
full cyclic shift,

    bucket_j(i) = (pos(i) + m[j, t]) mod c_pad ,     pos(i) = i mod c_pad

with ``m`` drawn from a seeded numpy ``RandomState`` in the same calls and
order as the JAX package, and per-(row, coordinate) signs from the murmur3
fmix32 finalizer of ``idx ^ key_j``.

Two operations carry the round, each with a CUDA kernel for the H100
(``commefficient_torch/csrc/sketch_kernels.cu``) and a plain PyTorch version
in this module:

- ``sketch_accumulate``: ``(Tn, S, 128)`` chunks -> ``(r, S, 128)`` table,
  the per-cell adds in chunk order from a zero table (the JAX ``lax.scan``
  fold), so kernel and plain version agree bit for bit;
- ``sketch_estimates``: the median-of-rows query, ``(r, S, 128)`` table ->
  ``(Tn, S, 128)`` estimates, tail left as hash noise for the caller's
  ``mask_tail``.

Dispatch rule of both: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel (which raises on what it cannot take). There is no
fallback from a kernel to its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from commefficient_torch.ops.flat import LANES, ChunkLayout

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

def _sketch_accumulate_plain(v3, shift_q, shift_w, sign_keys, t0: int = 0):
    """Plain PyTorch accumulate (a transcription of ``_sketch_chunks_jax``):
    chunk t lands in row j at ``table[j, c] += sign * v3[t, (c - m) mod
    c_pad]``, chunks added in t order to a zero table."""
    Tn, S, _ = v3.shape
    c_pad = S * LANES
    r = shift_q.shape[0]
    dev = v3.device
    pos = torch.arange(c_pad, device=dev, dtype=torch.int64)
    m = shift_q.to(torch.int64) * LANES + shift_w.to(torch.int64)  # (r, Tn)
    keys = sign_keys.reshape(r, 1)
    table = torch.zeros((r, c_pad), dtype=torch.float32, device=dev)
    for t in range(Tn):
        signs = _signs_for((t0 + t) * c_pad + pos[None, :], keys)  # (r, c_pad)
        sv = v3[t].reshape(1, c_pad) * signs
        src = (pos[None, :] - m[:, t:t + 1]) % c_pad
        table = table + torch.gather(sv, 1, src)
    return table.view(r, S, LANES)


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


def sketch_vec(cs: CountSketch, v: torch.Tensor) -> torch.Tensor:
    """Accumulate a dense ``(d,)`` vector into an ``(r, c_pad)`` table."""
    return sketch_chunks(cs, _chunks3(cs, v))


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


def sketch_estimates(table3: torch.Tensor, cs: CountSketch,
                     t0: int = 0, Tn: Optional[int] = None) -> torch.Tensor:
    """The median-of-rows query (``_estimates_pallas``'s contract):
    estimates of the ``Tn`` chunks from global chunk ``t0`` as
    ``(Tn, S, 128)``; the padded tail holds hash noise. The kernel reads
    ``row_j[(p + m) mod c_pad]`` with the FORWARD shifts; the plain version
    rolls by the inverse shifts; both give the same values."""
    Tn = cs.T if Tn is None else Tn
    if t0 == 0 and Tn == cs.T:
        fq, fw, iq, iw = cs.shift_q, cs.shift_w, cs.inv_q, cs.inv_w
    else:
        fq, fw = _shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
        iq, iw = _shift_cols(cs.inv_q, cs.inv_w, t0, Tn)
    if table3.device.type == "cpu":
        return _sketch_estimates_plain(table3, iq, iw, cs.sign_keys, t0)
    from commefficient_torch import kernels

    return kernels.sketch_estimates(table3.contiguous(), fq, fw,
                                    cs.sign_keys, t0)


def estimates_chunks(cs: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """Median-of-rows estimates in the ``(T, S, 128)`` resident layout with
    the padded tail masked to zero."""
    table3 = table.reshape(cs.r, cs.sublanes, LANES)
    return cs.chunk_layout.mask_tail(sketch_estimates(table3, cs))


def estimates(cs: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """Median-of-rows estimate of every coordinate, ``(d,)``."""
    return cs.chunk_layout.unchunk(estimates_chunks(cs, table))


def unsketch_chunks(cs: CountSketch, table: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Top-k of the masked estimate chunks, shape-preserving (tail zero)."""
    from commefficient_torch.ops.topk import topk_dense_nd

    return topk_dense_nd(estimates_chunks(cs, table), k)


def unsketch(cs: CountSketch, table: torch.Tensor, k: int) -> torch.Tensor:
    """Dense ``(d,)`` vector of the k largest-magnitude estimates."""
    return cs.chunk_layout.unchunk(unsketch_chunks(cs, table, k))


def l2estimate(table: torch.Tensor) -> torch.Tensor:
    """Median-of-rows estimate of the sketched vector's L2 norm."""
    sq = torch.sum(torch.square(table), dim=1)
    return torch.sqrt(_median_small([sq[i] for i in range(sq.shape[0])]))
