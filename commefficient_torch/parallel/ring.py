"""Ring attention over a ``seq`` group: the port of
``commefficient_tpu/parallel/ring.py``.

The sequence is split over the ranks of the group in rank order (rank
``i`` holds positions ``[i * T_local, (i + 1) * T_local)``). Each rank
keeps its queries and passes its key/value block round the ring: ``n - 1``
hops of (attend to the block it holds, send it to rank ``i + 1``, receive
one from rank ``i - 1``), then the last block is attended to without a
shift. The blocks accumulate in an fp32 online softmax (running max,
normalizer and output), so attention stays exact over the global
sequence while a rank holds ``T / n`` of it. The masked value is ``_NEG =
-0.7 * finfo(float32).max``, never ``-inf``: ``exp(_NEG - m)`` is 0 and no
NaN appears on a row that a whole block masks.

The neighbour shift is one ``torch.autograd.Function`` (``_Shift``) whose
backward shifts the cotangent the other way (the transpose of JAX's
``ppermute``) and whose ``vmap`` rule shifts the whole batched tensor
once, so the attention runs inside the fused client phase's
``torch.func.vmap``. Keys and values travel stacked, one exchange a hop.
Its transport is ``ops/collectives.send_recv``, chosen by the group's
backend name, fixed when the group is built (``ClientGroup.backend``):
point-to-point ``batch_isend_irecv`` on the tensor's own device, except
for ``gloo`` on a CUDA tensor, whose block is staged through host memory
first (gloo's point-to-point reads and writes the raw buffer and moves
host memory only).
"""

from __future__ import annotations

from typing import Optional

import torch

from commefficient_torch.ops.collectives import send_recv

__all__ = ["ring_attention"]

_NEG = -0.7 * torch.finfo(torch.float32).max  # large-negative mask, NaN-free


def _shift(x: torch.Tensor, cg, offset: int) -> torch.Tensor:
    """Send ``x`` to group rank ``rank + offset`` and return what rank
    ``rank - offset`` sent (mod the group's size)."""
    n = cg.size
    return send_recv(x, cg, (cg.rank + offset) % n, (cg.rank - offset) % n)


class _Shift(torch.autograd.Function):
    """One hop round the ring; the backward hops back."""

    @staticmethod
    def forward(x, cg):
        return _shift(x, cg, 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cg = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return _shift(ct, ctx.cg, -1), None

    @staticmethod
    def vmap(info, in_dims, x, cg):
        return _Shift.apply(x, cg), in_dims[0]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence split over ``group`` (a
    ``parallel/mesh.ClientGroup``: its process group, rank and size).
    ``q, k, v``: ``(B, T_local, H, D)``, this rank's slice of the global
    sequence in rank order. Returns this rank's ``(B, T_local, H, D)``
    slice of the output, in ``q``'s dtype."""
    B, Tq, H, D = q.shape
    n, my = group.size, group.rank
    scale = (D ** -0.5) if scale is None else scale
    dev = q.device
    q32 = q.to(torch.float32) * scale
    q_pos = my * Tq + torch.arange(Tq, device=dev)

    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for step in range(n):
        kb, vb = kv[0], kv[1]
        Tk = kb.shape[1]
        # at hop t a rank holds the block rank (my - t) mod n started with:
        # the blocks arrive in decreasing order
        kv_idx = (my - step) % n
        k_pos = kv_idx * Tk + torch.arange(Tk, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.to(torch.float32))
        if causal:
            allowed = k_pos[None, :] <= q_pos[:, None]          # (Tq, Tk)
            s = torch.where(allowed[None, None], s,
                            torch.full((), _NEG, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))                 # (B, H, Tq)
        p = torch.exp(s - m_new[..., None])       # masked: exp(-huge) = 0
        corr = torch.exp(m - m_new)               # first hop: exp(-huge) = 0
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vb.to(torch.float32))
        o = o * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if step < n - 1:
            # n - 1 hops; the last block is consumed without a shift
            kv = _Shift.apply(kv, group)
    # fully masked rows (a non-causal edge) stay 0
    l = torch.clamp(l, min=1e-30)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)
