"""The mixture-of-experts MLP with expert parallelism over an ``expert``
axis of ranks: the port of ``commefficient_tpu/parallel/moe.py``
(``MoEMLP``, ``ep_sliced_param``).

- **Routing**: top-1 (Switch) in float32: a linear router (no bias) scores
  every token against every expert; each token takes its argmax expert's
  output, weighted by that expert's softmax probability. The argmax
  one-hot is a constant; the router's gradient flows through the
  selected probability.
- **Dispatch** (``dispatch``): ``dense`` runs every local expert on every
  token and zeroes the non-routed outputs with the combine weights;
  ``sparse`` is the capacity-factor dispatch: each expert takes the
  tokens routed to it, in token order, up to ``round(capacity_factor * N
  / E)`` of them (a cumulative sum gives each token its queue position);
  the tokens past that are dropped from the MoE output (the block's
  residual passes them through). Tokens move through one-hot dispatch
  products, as in the JAX package. At ``capacity_factor >= E`` no token
  drops and the output equals dense dispatch.
- **Expert parallelism** (``expert_group``, a ``parallel/mesh.
  ClientGroup`` along the ``expert`` axis): the parameters stay full-shape
  on every rank, so the flat vector, compression and checkpoints never
  see the axis. Rank ``e`` of ``ne`` computes experts ``[e * E/ne, (e +
  1) * E/ne)``; its input goes through ``ops/collectives.ident_psumct``
  before the router (the input's cotangent from the router and expert
  paths is summed over the axis) and its partial output through
  ``psum_repct``. So the expert-stacked leaves and the router get
  slice-local gradients (summed over the axis at scale 1,
  ``ep_sliced_param``) and everything else identical ones (scale 1/ne in
  the round's ``ep_scale``).

The Switch load-balancing aux ``E * sum_e f_e * P_e`` (``f_e``: the
fraction of tokens routed to expert ``e``; ``P_e``: its mean router
probability) is computed from the local expert slice; under sequence
parallelism (``seq_group``) ``f`` and ``P`` are made global with
``psum_repct`` divided by the seq size, and under expert parallelism the
aux is summed over the expert axis with ``psum_repct``. Flax sows it into
a collection; here ``forward`` returns ``(out, aux)``, a tensor a
``torch.func.vmap`` over clients carries.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from commefficient_torch.ops.collectives import ident_psumct, psum_repct

__all__ = ["MoEMLP", "ep_sliced_param"]

DISPATCHES = ("dense", "sparse")


def ep_sliced_param(path: str) -> bool:
    """True for parameters whose per-rank gradients SUM to the full
    gradient over the expert axis (scale 1): the expert-stacked MLP
    weights and biases and the router (each rank's router gradient is the
    backward of its local experts' combine weights alone). ``path`` is
    the '/'-joined lowercase flax path."""
    return "/moe/" in path or path.startswith("moe/")


def one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an all-zero row for an index outside ``[0,
    n)``; a comparison, so ``torch.func.vmap`` batches it."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(
        dtype)


class MoEMLP(nn.Module):
    """Top-1-routed mixture-of-experts MLP (the module docstring), with
    flax's leaves: ``router`` ``(C, E)``, ``w_fc`` ``(E, C, 4C)``,
    ``b_fc`` ``(E, 4C)``, ``w_proj`` ``(E, 4C, C)``, ``b_proj`` ``(E,
    C)``. ``forward(x)`` returns ``(out, aux)``."""

    def __init__(self, n_embd: int, n_experts: int, expert_group=None,
                 seq_group=None, dispatch: str = "dense",
                 capacity_factor: float = 1.25):
        super().__init__()
        assert dispatch in DISPATCHES, f"unknown dispatch {dispatch!r}"
        C, E = n_embd, n_experts
        if expert_group is not None:
            assert E % expert_group.size == 0, \
                f"n_experts {E} must divide by the expert axis size " \
                f"{expert_group.size}"
        self.n_embd, self.n_experts = C, E
        self.expert_group = expert_group
        self.seq_group = seq_group
        self.dispatch = dispatch
        self.capacity_factor = float(capacity_factor)
        self.router = nn.Parameter(torch.zeros(C, E))
        self.w_fc = nn.Parameter(torch.zeros(E, C, 4 * C))
        self.b_fc = nn.Parameter(torch.zeros(E, 4 * C))
        self.w_proj = nn.Parameter(torch.zeros(E, 4 * C, C))
        self.b_proj = nn.Parameter(torch.zeros(E, C))

    def expert_slice(self) -> slice:
        """This rank's experts (all of them without an expert group)."""
        if self.expert_group is None:
            return slice(0, self.n_experts)
        n_loc = self.n_experts // self.expert_group.size
        e0 = self.expert_group.rank * n_loc
        return slice(e0, e0 + n_loc)

    def forward(self, x: torch.Tensor):
        """``x``: ``(B, T, C)``. Returns ``(out (B, T, C), aux ())``."""
        E = self.n_experts
        eg = self.expert_group
        if eg is not None:
            # before the router: both consumers' cotangents ride the sum
            x = ident_psumct(x, eg)
        probs, top = self._route(x)                   # (B, T, E), (B, T)
        oh = one_hot(top, E, probs.dtype)                     # (B, T, E)
        combine = (oh * probs).to(x.dtype)
        sl = self.expert_slice()

        f_loc = torch.mean(oh[..., sl], dim=(0, 1))
        p_loc = torch.mean(probs[..., sl], dim=(0, 1))
        if self.seq_group is not None:
            nsq = self.seq_group.size
            f_loc = psum_repct(f_loc, self.seq_group) / nsq
            p_loc = psum_repct(p_loc, self.seq_group) / nsq
        aux = float(E) * torch.sum(f_loc * p_loc)
        if eg is not None:
            aux = psum_repct(aux, eg)

        if self.dispatch == "sparse":
            out = self._sparse(x, top, combine, sl)
        else:
            h = torch.einsum("btc,ecf->ebtf", x, self.w_fc[sl]) \
                + self.b_fc[sl][:, None, None, :]
            h = F.gelu(h, approximate="tanh")
            y = torch.einsum("ebtf,efc->ebtc", h, self.w_proj[sl]) \
                + self.b_proj[sl][:, None, None, :]
            out = torch.einsum("bte,ebtc->btc", combine[..., sl], y)
        if eg is not None:
            # the partial combines summed: the full MoE output
            out = psum_repct(out, eg)
        return out, aux

    def _route(self, x):
        """Top-1 routing in float32: the router's softmax and its argmax."""
        logits = x.to(torch.float32) @ self.router.to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        return probs, torch.argmax(probs, dim=-1)

    def _queue_positions(self, sel):
        """Each token's position among the tokens routed to its expert, in
        token order (``sel``: ``(N,)`` expert indices)."""
        ohs = one_hot(sel, self.n_experts, torch.int32)       # (N, E)
        return torch.sum((torch.cumsum(ohs, dim=0) - 1) * ohs, dim=1)

    def capacity(self, n_tokens: int) -> int:
        """Tokens an expert takes under sparse dispatch (the JAX package's
        ``max(1, int(round(cf * N / E)))``)."""
        return max(1, int(round(self.capacity_factor * n_tokens
                                / self.n_experts)))

    def _sparse(self, x, top, combine, sl):
        """Capacity-factor dispatch: each token to its expert's queue slot
        (its position among the tokens routed there, in token order);
        a slot at or past the capacity is an all-zero dispatch row, so
        the token drops out of the output."""
        B, T, C = x.shape
        E = self.n_experts
        N = B * T
        cap = self.capacity(N)
        xf = x.reshape(N, C)
        sel = top.reshape(N)
        pos = self._queue_positions(sel)
        de = one_hot(sel, E, x.dtype)                         # (N, E)
        dp = one_hot(pos, cap, x.dtype)                       # (N, Cap)
        d = de[:, :, None] * dp[:, None, :]                   # (N, E, Cap)
        d_loc = torch.movedim(d, 1, 0)[sl]                    # (E_loc, N, Cap)
        xin = torch.einsum("enp,nc->epc", d_loc, xf)
        h = torch.einsum("epc,ecf->epf", xin, self.w_fc[sl]) \
            + self.b_fc[sl][:, None, :]
        h = F.gelu(h, approximate="tanh")
        y = torch.einsum("epf,efc->epc", h, self.w_proj[sl]) \
            + self.b_proj[sl][:, None, :]
        gate = torch.sum(combine, dim=-1).reshape(N, 1)
        out = torch.einsum("enp,epc->nc", d_loc, y) * gate
        return out.reshape(B, T, C)

    def kept_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The sparse dispatch's kept-token mask ``(B, T)`` of input ``x``
        (True: the token took a queue slot within the capacity), for
        checks; no gradient."""
        with torch.no_grad():
            sel = self._route(x)[1].reshape(-1)
            return (self._queue_positions(sel)
                    < self.capacity(sel.numel())).reshape(x.shape[:-1])
