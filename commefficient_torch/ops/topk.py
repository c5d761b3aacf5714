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

The count pass has a CUDA kernel (``topk_count_ge``). The descent keeps the
prefix, the candidates and the selected nibble on the device between the 8
passes: no host sync.
"""

from __future__ import annotations

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


def resolve_threshold(vec: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th-largest-magnitude bit pattern of ``vec`` (any shape,
    float32) as a 0-d int32 tensor on its device."""
    raw = vec.contiguous().view(torch.int32).reshape(-1)
    p = torch.zeros((), dtype=torch.int32, device=vec.device)
    for shift in range(28, -1, -4):
        counts = topk_count_ge(raw, _pass_thresholds(p, shift))
        # counts are non-increasing in the threshold, so the chosen nibble
        # is the number of candidates whose count still reaches k
        sel = (counts >= k).sum().to(torch.int32)
        p = p + (sel << shift)
    return p


def _apply_threshold(raw: torch.Tensor, vec: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """Dense-masked result: keep ``mag >= p`` (tie-inclusive), re-insert
    NaNs."""
    m = raw & _ABS_MASK
    mag = torch.where(m > _INF_BITS, torch.zeros_like(m), m)
    zero = torch.zeros((), dtype=vec.dtype, device=vec.device)
    out = torch.where(mag >= p, vec, zero)
    return torch.where(m > _INF_BITS, vec, out)


def topk_dense_nd(vec: torch.Tensor, k: int) -> torch.Tensor:
    """Shape-preserving global magnitude top-k over every element of
    ``vec`` (the chunked-resident round's entry point). Zero positions
    (a chunk layout's masked tail) never win a nonzero threshold; when
    fewer than k nonzeros exist, everything is kept."""
    vec = vec.contiguous()
    raw = vec.view(torch.int32)
    return _apply_threshold(raw, vec, resolve_threshold(vec, k))


def topk(vec: torch.Tensor, k: int, method: str = "threshold") -> torch.Tensor:
    """Dense vector with only the k largest-magnitude entries kept; 1-D
    ``(d,)`` or row-wise over 2-D ``(rows, d)``."""
    if method != "threshold":
        raise NotImplementedError(
            f"topk method {method!r} is not ported; the port has the "
            "tie-inclusive threshold descent only (ROADMAP.md, queue 1)")
    if vec.ndim == 1:
        return topk_dense_nd(vec, k)
    if vec.ndim == 2:
        return torch.stack([topk_dense_nd(row, k) for row in vec])
    raise ValueError(f"topk supports 1-D or 2-D input, got ndim={vec.ndim}")
