"""Magnitude top-k sparsification: the port of ``commefficient_tpu/ops/topk.py``.

The callers only need the dense masked result, so the selection is the
k-th largest magnitude found exactly as a scalar threshold by a radix-nibble
descent over the int32 bit patterns of ``|v|`` (non-negative IEEE-754 floats
compare identically as integers): 8 passes, each counting how many
magnitudes reach each of 16 candidate extensions of the resolved prefix and
keeping the largest whose count still reaches k. Properties, as in the JAX
package:

- tie-inclusive: every coordinate whose magnitude equals the k-th is kept
  (``torch.topk`` breaks ties by index, so it is never a substitute);
- NaN coordinates are excluded from the search (their patterns exceed the
  inf pattern and count as 0) and re-inserted in the output, so divergence
  stays visible to the NaN abort of the train loop.

Two kernels serve the descent. The default, as in the JAX package, is the
per-pass descent: 8 launches of the count pass (``topk_count_ge``), with
the prefix, the candidates and the selected nibble kept on the device
between them (no host sync). ``COMMEFFICIENT_PALLAS_TOPK_FUSED=1`` (the JAX
package's switch, read only by ``fused_descent_enabled``; default off)
chooses one launch for the whole search (``topk_descent``): on the card a
3-pass histogram radix select (``csrc/topk_descent.cu``), whose plain
version is the 8-pass descent. All of them count exact integers, so they
return the same threshold on every input.

The sharded server's threshold exchange (``group``, a
``parallel/mesh.ClientGroup``): each rank counts over its local slice and
each pass's 16 counts are summed over the group as int64
(``all_reduce``), 16 integers a pass instead of the full vector. The
sharded path always takes the per-pass descent, as the JAX package does.

``topk(..., method="sort")`` keeps exactly ``min(k, d)`` entries by a
stable descending ``torch.sort`` of the magnitudes, the lower index
winning among ties (``lax.top_k``'s tie-break), for callers that need the
reference's tie-breaking.
"""

from __future__ import annotations

import os

import torch

_ABS_MASK = 0x7FFFFFFF
_INF_BITS = 0x7F800000  # |pattern| above this <=> NaN
N_CANDIDATES = 16


def _mag(raw: torch.Tensor) -> torch.Tensor:
    m = raw & _ABS_MASK
    return torch.where(m > _INF_BITS, torch.zeros_like(m), m)


def _count_ge_plain(bits: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Plain count step of the descent (``_threshold_descent_xla``):
    ``counts[j] = #{i : mag(bits_i) >= ts[j]}``, int32 ``(16,)``."""
    m = _mag(bits.reshape(-1))
    return torch.stack([(m >= ts[j]).sum() for j in range(ts.shape[0])]
                       ).to(torch.int32)


def topk_count_ge(bits: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """One radix-descent pass (``_count_ge_pallas``'s contract) over the
    flat int32 bit patterns ``bits`` against 16 int32 thresholds ``ts``
    (unused candidates padded with ``0x7FFFFFFF``, which no magnitude
    reaches). Returns int32 ``(16,)`` on the device of ``bits``."""
    if bits.device.type == "cpu":
        return _count_ge_plain(bits, ts)
    from commefficient_torch import kernels

    return kernels.topk_count_ge(bits.reshape(-1), ts)


def _pass_thresholds(p: torch.Tensor, shift: int) -> torch.Tensor:
    """The 16 candidate thresholds of one pass: ``p + (j << shift)`` for
    j = 1..15 (1..7 in the first pass, whose top nibble is at most 7 for
    any finite ``|float|``), padded with ``0x7FFFFFFF``."""
    hi_nib = 8 if shift == 28 else 16
    cand = torch.arange(1, hi_nib, dtype=torch.int32, device=p.device) << shift
    pad = torch.full((N_CANDIDATES - (hi_nib - 1),), _ABS_MASK,
                     dtype=torch.int32, device=p.device)
    return torch.cat([p + cand, pad])


def _descent(bits: torch.Tensor, k: int, count) -> torch.Tensor:
    """The 8-pass radix descent over flat int32 bit patterns with the
    count pass ``count(bits, thresholds)``; the k-th largest magnitude's
    pattern as a 0-d int32 tensor on the device of ``bits``."""
    p = torch.zeros((), dtype=torch.int32, device=bits.device)
    for shift in range(28, -1, -4):
        counts = count(bits, _pass_thresholds(p, shift))
        # counts are non-increasing in the threshold, so the chosen nibble
        # is the number of candidates whose count still reaches k
        sel = (counts >= k).sum().to(torch.int32)
        p = p + (sel << shift)
    return p


def _descent_plain(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Plain whole descent (``_threshold_descent_fused``'s contract): the
    8 passes with the plain count, the prefix carried between them."""
    return _descent(bits, k, _count_ge_plain)


def topk_descent(bits: torch.Tensor, k: int) -> torch.Tensor:
    """The whole descent in one launch (``_descent_pallas``'s contract)
    over flat int32 bit patterns. Returns the k-th largest magnitude's
    pattern as a 0-d int32 tensor on the device of ``bits``."""
    if bits.device.type == "cpu":
        return _descent_plain(bits, k)
    from commefficient_torch import kernels

    return kernels.topk_descent(bits.reshape(-1), k)


FUSED_DESCENT_ENV = "COMMEFFICIENT_PALLAS_TOPK_FUSED"


def fused_descent_enabled() -> bool:
    """``COMMEFFICIENT_PALLAS_TOPK_FUSED=1`` chooses the one-launch
    descent; unset (the default, as in the JAX package) or any other
    value keeps the per-pass descent."""
    return os.environ.get(FUSED_DESCENT_ENV) == "1"


def exchanged_count(group):
    """The count pass of the threshold exchange: the local counts summed
    over ``group`` as int64."""
    from commefficient_torch.ops.collectives import all_reduce_sum

    def count(bits, ts):
        return all_reduce_sum(topk_count_ge(bits, ts).to(torch.int64),
                              group)

    return count


def resolve_threshold(vec: torch.Tensor, k: int,
                      group=None) -> torch.Tensor:
    """The k-th-largest-magnitude bit pattern of ``vec`` (any shape,
    float32) as a 0-d int32 tensor on its device, by the one-launch
    descent or the per-pass one (``fused_descent_enabled``). With
    ``group``, ``vec`` is this rank's slice and the threshold is the
    global one, from the per-pass descent over exchanged counts."""
    raw = vec.contiguous().view(torch.int32).reshape(-1)
    if group is not None:
        return _descent(raw, k, exchanged_count(group))
    if fused_descent_enabled():
        return topk_descent(raw, k)
    return _descent(raw, k, topk_count_ge)


def _apply_threshold(raw: torch.Tensor, vec: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """Dense-masked result: keep ``mag >= p`` (tie-inclusive), re-insert
    NaNs."""
    m = raw & _ABS_MASK
    mag = torch.where(m > _INF_BITS, torch.zeros_like(m), m)
    zero = torch.zeros((), dtype=vec.dtype, device=vec.device)
    out = torch.where(mag >= p, vec, zero)
    return torch.where(m > _INF_BITS, vec, out)


def topk_dense_nd(vec: torch.Tensor, k: int, group=None) -> torch.Tensor:
    """Shape-preserving global magnitude top-k over every element of
    ``vec`` (the chunked-resident round's entry point). Zero positions
    (a chunk layout's masked tail) never win a nonzero threshold; when
    fewer than k nonzeros exist, everything is kept. With ``group``,
    ``vec`` is this rank's slice of the vector and the threshold comes
    from the exchange over the group."""
    vec = vec.contiguous()
    raw = vec.view(torch.int32)
    return _apply_threshold(raw, vec, resolve_threshold(vec, k, group))


def _topk_sort_1d(vec: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly ``min(k, d)`` entries kept: the largest magnitudes by a
    stable descending sort, so among ties the lower index wins, as
    ``lax.top_k`` breaks them."""
    idx = torch.sort(vec.abs(), descending=True, stable=True).indices[
        :min(k, vec.shape[0])]
    return torch.zeros_like(vec).index_copy_(0, idx, vec[idx])


def topk(vec: torch.Tensor, k: int, method: str = "threshold") -> torch.Tensor:
    """Dense vector with only the k largest-magnitude entries kept; 1-D
    ``(d,)`` or row-wise over 2-D ``(rows, d)``. ``method="threshold"``
    keeps every entry tied at the cut (the descent); ``"sort"`` keeps
    exactly k, the reference's tie-break by lower index."""
    if method == "threshold":
        f = topk_dense_nd
    elif method == "sort":
        f = _topk_sort_1d
    else:
        raise ValueError(f"unknown topk method {method!r}")
    if vec.ndim == 1:
        return f(vec, k)
    if vec.ndim == 2:
        return torch.stack([f(row, k) for row in vec])
    raise ValueError(f"topk supports 1-D or 2-D input, got ndim={vec.ndim}")
