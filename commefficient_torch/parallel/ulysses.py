"""Ulysses sequence parallelism over a ``seq`` group: the port of
``commefficient_tpu/parallel/ulysses.py``.

One ``all_to_all`` re-shards ``q``, ``k`` and ``v`` from sequence-split
``(B, T/n, H, D)`` to head-split ``(B, T, H/n, D)``, each rank runs dense
attention over the whole sequence on its head group (fp32 scores, the
causal mask at ``finfo(float32).min``), and a second ``all_to_all``
restores the sequence split. It needs ``H % n == 0``. Each exchange is a
``torch.autograd.Function`` whose backward is the inverse exchange and
whose ``vmap`` rule moves the whole batched tensor once (the fused client
phase runs the model under ``torch.func.vmap``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ulysses_attention"]


def _all_to_all(x: torch.Tensor, cg) -> torch.Tensor:
    """Dim-0 tile ``j`` to group rank ``j``; every rank's tile for this
    rank back, stacked in rank order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=cg.group)
    return out


def _seq_to_head(x: torch.Tensor, cg) -> torch.Tensor:
    """``(..., T/n, H, D)`` -> ``(..., T, H/n, D)``: head group ``j`` to
    rank ``j``; the received sequence slices concatenated in rank
    order."""
    n = cg.size
    *lead, Tl, H, D = x.shape
    x = x.reshape(*lead, Tl, n, H // n, D).movedim(-3, 0)
    y = _all_to_all(x, cg)                       # (n, ..., Tl, H/n, D)
    return y.movedim(0, -4).reshape(*lead, n * Tl, H // n, D)


def _head_to_seq(x: torch.Tensor, cg) -> torch.Tensor:
    """``(..., T, H/n, D)`` -> ``(..., T/n, H, D)``, the inverse."""
    n = cg.size
    *lead, T, Hl, D = x.shape
    x = x.reshape(*lead, n, T // n, Hl, D).movedim(-4, 0)
    y = _all_to_all(x, cg)                       # (n, ..., T/n, H/n, D)
    return y.movedim(0, -3).reshape(*lead, T // n, n * Hl, D)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(x, cg):
        return _seq_to_head(x, cg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cg = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return _head_to_seq(ct, ctx.cg), None

    @staticmethod
    def vmap(info, in_dims, x, cg):
        bdim = in_dims[0]
        if bdim is not None:
            x = x.movedim(bdim, 0)
        return _SeqToHead.apply(x, cg), (None if bdim is None else 0)


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(x, cg):
        return _head_to_seq(x, cg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cg = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return _seq_to_head(ct, ctx.cg), None

    @staticmethod
    def vmap(info, in_dims, x, cg):
        bdim = in_dims[0]
        if bdim is not None:
            x = x.movedim(bdim, 0)
        return _HeadToSeq.apply(x, cg), (None if bdim is None else 0)


def _dense_attention(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s,
                        torch.full((), torch.finfo(torch.float32).min,
                                   device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence split over ``group`` (a
    ``parallel/mesh.ClientGroup``). ``q, k, v``: ``(B, T_local, H, D)``,
    this rank's slice in rank order; ``H`` divisible by the group's size.
    Returns this rank's ``(B, T_local, H, D)`` slice of the output."""
    D = q.shape[-1]
    assert q.shape[-2] % group.size == 0, \
        f"ulysses needs n_head {q.shape[-2]} divisible by {group.size}"
    scale = (D ** -0.5) if scale is None else scale
    qg, kg, vg = (_SeqToHead.apply(t, group) for t in (q, k, v))
    out = _dense_attention(qg, kg, vg, causal, scale)
    return _HeadToSeq.apply(out, group)
