"""GPT-2 with double heads (LM + multiple-choice): the port of
``commefficient_tpu/models/gpt2.py`` (``GPT2Config``, ``Block``,
``GPT2DoubleHeads`` with dense attention, ``resize_token_embeddings``).

The math follows the flax module step for step: token and position
embeddings (``token_type_ids`` embed through the token table), pre-LN
blocks (``LayerNorm`` with epsilon 1e-5) with one packed q|k|v projection,
causal attention scaled by ``1 / sqrt(head_dim)`` (a Python float, so a
bf16 forward stays bf16) and masked with ``finfo.min`` (not ``-inf``),
``gelu(approximate="tanh")``, the LM head tied to ``wte`` (flax's
``wte.attend``: ``x @ wte.T``), and the MC head reading the hidden state at
``mc_token_ids``.

Parameters carry their flax paths (``h0`` ... ``h11`` / ``ln_1``,
``attn_qkv``, ``attn_proj``, ``ln_2``, ``mlp_fc``, ``mlp_proj`` /
``ln_f``, ``mc_head``, ``wpe``, ``wte``) and their layout kinds, which fix
the flat vector in JAX ravel order (``ops/flat.ParamLayout``; ``h10`` and
``h11`` sort before ``h2``): the four projections and the MC head are
``nn.Linear`` (``dense``: flax's kernel is ``(in, out)``), the
embeddings and the LayerNorm leaves ``asis`` (flax stores an embedding
``(num, features)``, as ``nn.Embedding`` does).

Dropout (p = ``dropout``, 0.1 by default) sits where flax's does: after
the embeddings, on the attention probabilities, and on both residual
branches of every block. Its keep masks come from the ``dropout``
argument of ``forward``, never from the global RNG: a ``GeneratorKeep``
draws them from an explicit ``torch.Generator``, a ``MaskKeep`` slices
them, in call order, from a flat boolean tensor drawn beforehand (the
batched input a ``torch.func.vmap`` over clients takes,
``dropout_numel`` long). ``dropout=None`` is the deterministic (eval)
forward. A kept value is ``x / (1 - p)``, as in flax.

``load_hf_gpt2`` reads HF-format GPT-2 weights from a local directory
(``pytorch_model.bin`` through ``torch.load(weights_only=True)``, else
``model.safetensors`` parsed here with ``torch.frombuffer``; BF16 tensors
become float32, exactly) into a flax-layout parameter tree: HF's
``Conv1D`` weights are stored ``(in, out)``, as flax's ``kernel`` is, so
each lands in the leaf's declared layout and crosses into the modules
through ``convert.params_from_flax``. Nothing is downloaded.

Sequence parallelism (``attn_impl="ring"`` or ``"ulysses"`` with
``seq_group``, a ``parallel/mesh.ClientGroup`` over the ``seq`` axis): the
model runs on this rank's slice of the sequence (``input_ids`` and
``token_type_ids`` cut on their last axis, in rank order). Attention runs
exactly over the global sequence (``parallel/ring.py``,
``parallel/ulysses.py``), with no dense causal mask and no dropout on the
attention probabilities (the residual and embedding dropouts remain, as
in the JAX package); the position embeddings start at ``seq_index *
T_local``; the multiple-choice head reads the classification token
(``mc_token_ids``: a global position) on the rank that holds it, runs
the head on that rank's hidden state, masks the scalar logit to that
rank and sums it over the group through ``ops/collectives.psum_repct``,
whose backward is the identity, so every parameter's gradient on a rank
is its slice's part and the ranks' gradients sum to the dense one. The
parameters are the dense model's.

Tensor parallelism (``model_group``, a ``ClientGroup`` over the ``model``
axis): the parameters stay full-shape, so the flat vector, the HF loader
and ``convert.py`` never see the axis; each block computes ``n_head / M``
local heads and ``4 C / M`` MLP columns (``TPDense``: ``mode="col"``
slices the output features, per block of the packed q|k|v, and runs
``ident_psumct`` on its input; ``mode="row"`` slices the input features
and sums its output over the group with ``psum_repct``, then adds the bias
once). It composes with dense or ring attention; Ulysses, which splits
the heads over the seq axis, is refused as in the JAX package. The
residual and embedding dropout masks are the same on every model rank
(one generator); the attention-probability mask has the local-head shape
and the same pattern on every rank. The round sums the slice-local
gradients over the group and rescales by ``tp_scale`` (1 on the leaves
``tp_sliced_param`` names, 1/M on the rest).

Mixture of experts (``n_experts > 0``): block ``i`` with ``i % moe_every
== moe_every - 1`` (every other block by default) replaces its MLP by
``parallel/moe.MoEMLP`` (flax leaves ``h{i}/moe/{router, w_fc, b_fc,
w_proj, b_proj}``), its experts split over ``expert_group`` when given.
``forward(..., return_aux=True)`` also returns the MoE layers' Switch aux
losses, one a layer, as a tensor (flax sows them into a collection).
``load_hf_gpt2`` prints the JAX package's warning for the MoE blocks and
leaves their experts as initialized.

The pipeline (``parallel/pipeline.make_gpt2_pp_losses``) runs this
model's blocks, each stage its own range, and writes its own embedding
and heads; the parameters are the dense model's.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from commefficient_torch.ops.collectives import ident_psumct, psum_repct
from commefficient_torch.parallel.moe import MoEMLP

__all__ = ["GPT2Config", "GPT2DoubleHeads", "Block", "GeneratorKeep",
           "MaskKeep", "TPDense", "resize_token_embeddings", "load_hf_gpt2",
           "tp_sliced_param"]

LN_EPSILON = 1e-5


def tp_sliced_param(path: str) -> bool:
    """True for parameters whose gradient each model rank computes for its
    slice alone (``TPDense``): the packed qkv projection and the MLP
    up-projection (kernel and bias, column-sliced), and the two
    row-sliced down-projection kernels. A row-sliced bias is added after
    the sum, so its gradient is replicated like every other parameter's.
    ``path`` is the '/'-joined lowercase flax path."""
    if "attn_qkv" in path or "mlp_fc" in path:
        return True
    return ("attn_proj" in path or "mlp_proj" in path) and "kernel" in path


class GPT2Config:
    """gpt2-small geometry by default."""

    def __init__(self, vocab_size=50257, n_positions=1024, n_embd=768,
                 n_layer=12, n_head=12, dropout=0.1):
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.n_embd = n_embd
        self.n_layer = n_layer
        self.n_head = n_head
        self.dropout = dropout


class GeneratorKeep:
    """Keep masks drawn from an explicit ``torch.Generator``:
    ``uniform < keep_prob`` (flax's ``bernoulli(keep_prob)``)."""

    def __init__(self, generator: torch.Generator, keep_prob: float):
        self.generator = generator
        self.keep_prob = float(keep_prob)

    def __call__(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=device) < self.keep_prob


class MaskKeep:
    """Keep masks sliced in call order from one flat boolean tensor drawn
    beforehand (``GPT2DoubleHeads.dropout_numel`` long)."""

    def __init__(self, flat: torch.Tensor):
        self.flat = flat
        self.offset = 0

    def __call__(self, shape, device) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= int(s)
        if self.offset + n > self.flat.shape[-1]:
            raise ValueError(f"dropout masks exhausted: {self.offset} + {n} "
                             f"> {self.flat.shape[-1]}")
        out = self.flat[self.offset:self.offset + n].reshape(shape)
        self.offset += n
        return out

    def check_consumed(self) -> None:
        if self.offset != self.flat.shape[-1]:
            raise ValueError(f"dropout masks: {self.offset} of "
                             f"{self.flat.shape[-1]} used")


def _dropout(x: torch.Tensor, rate: float, keep) -> torch.Tensor:
    """flax's ``nn.Dropout``: ``where(mask, x / keep_prob, 0)``; a no-op at
    rate 0 or without a mask source (deterministic)."""
    if keep is None or rate == 0.0:
        return x
    mask = keep(x.shape, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)`` over the last axis, with flax's
    leaf names ``scale`` and ``bias``."""

    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias,
                            LN_EPSILON)


class Embed(nn.Module):
    """flax ``nn.Embed``: a ``(num, features)`` table named ``embedding``,
    looked up, or attended (``x @ embedding.T``, the tied LM head)."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def forward(self, ids):
        return F.embedding(ids, self.embedding)

    def attend(self, x):
        return F.linear(x, self.embedding)


ATTN_IMPLS = ("dense", "ring", "ulysses")


class TPDense(nn.Linear):
    """An ``nn.Linear`` whose parameters are full-shape (the same leaves
    as without the axis: flax's kernel ``(in, out)`` is the transpose of
    ``weight``) and whose compute runs on this rank's slice of
    ``model_group``: ``mode="col"``, ``x @ kernel[:, cols] + bias[cols]``
    with the output features cut in ``blocks`` equal parts, each sliced on
    its own (the packed q|k|v needs a head slice of each part), behind
    ``ident_psumct``; ``mode="row"``, ``psum_repct(x_local @
    kernel[rows, :]) + bias`` (the reduction point; the bias added once,
    after the sum). Without a group, a plain ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int,
                 model_group=None, mode: str = "col", blocks: int = 1):
        super().__init__(in_features, out_features)
        assert mode in ("col", "row"), mode
        self.model_group = model_group
        self.mode = mode
        self.blocks = blocks
        if model_group is not None:
            nm = model_group.size
            split = out_features // blocks if mode == "col" else in_features
            assert split % nm == 0, \
                f"{split} features do not divide by the model axis {nm}"

    def forward(self, x):
        g = self.model_group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        nm, idx = g.size, g.rank
        if self.mode == "col":
            x = ident_psumct(x, g)
            blk = self.out_features // self.blocks
            sub = blk // nm
            rows = [b * blk + idx * sub for b in range(self.blocks)]
            w = torch.cat([self.weight[r:r + sub] for r in rows])
            bias = torch.cat([self.bias[r:r + sub] for r in rows])
            return F.linear(x, w, bias)
        sub = self.in_features // nm
        w = self.weight[:, idx * sub:(idx + 1) * sub]
        return psum_repct(F.linear(x, w), g) + self.bias


class Block(nn.Module):
    """Pre-LN transformer block: dense causal attention, or ring / Ulysses
    attention over ``seq_group`` (this rank's slice of the sequence, no
    attention-probs dropout); its heads and MLP columns sliced over
    ``model_group``; an MoE MLP in place of the dense one when
    ``n_experts > 0``, its experts over ``expert_group``. ``forward``
    returns ``(x, aux)``, ``aux`` None without MoE."""

    def __init__(self, n_embd: int, n_head: int, dropout: float,
                 attn_impl: str = "dense", seq_group=None, model_group=None,
                 n_experts: int = 0, expert_group=None,
                 moe_dispatch: str = "dense",
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.seq_group = seq_group
        self.model_group = model_group
        nm = model_group.size if model_group is not None else 1
        assert n_head % nm == 0, \
            f"n_head {n_head} does not divide by the model axis {nm}"
        self.n_local = n_head // nm
        self.ln_1 = LayerNorm(n_embd)
        self.attn_qkv = TPDense(n_embd, 3 * n_embd, model_group, "col",
                                blocks=3)
        self.attn_proj = TPDense(n_embd, n_embd, model_group, "row")
        self.ln_2 = LayerNorm(n_embd)
        if n_experts > 0:
            self.moe = MoEMLP(n_embd, n_experts, expert_group=expert_group,
                              seq_group=(seq_group if attn_impl != "dense"
                                         else None),
                              dispatch=moe_dispatch,
                              capacity_factor=moe_capacity_factor)
        else:
            self.mlp_fc = TPDense(n_embd, 4 * n_embd, model_group, "col")
            self.mlp_proj = TPDense(4 * n_embd, n_embd, model_group, "row")

    def forward(self, x, mask, keep=None):
        h = self.ln_1(x)
        B, T, C = h.shape
        # under tensor parallelism q|k|v hold this rank's local heads
        q, k, v = torch.chunk(self.attn_qkv(h), 3, dim=-1)
        hd = C // self.n_head
        nl = self.n_local
        q = q.reshape(B, T, nl, hd)
        k = k.reshape(B, T, nl, hd)
        v = v.reshape(B, T, nl, hd)
        if self.attn_impl == "dense":
            # a Python-float scale, as in flax (a bf16 forward stays bf16)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
                1.0 / float(np.sqrt(hd)))
            att = torch.where(mask, att, torch.finfo(att.dtype).min)
            att = torch.softmax(att, dim=-1)
            att = _dropout(att, self.dropout, keep)
            out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(
                B, T, nl * hd)
        else:
            # T is the local slice; the attention handles global causality
            from commefficient_torch.parallel.ring import ring_attention
            from commefficient_torch.parallel.ulysses import (
                ulysses_attention,
            )

            attn = {"ring": ring_attention,
                    "ulysses": ulysses_attention}[self.attn_impl]
            out = attn(q, k, v, self.seq_group, causal=True).reshape(
                B, T, nl * hd)
        x = x + _dropout(self.attn_proj(out), self.dropout, keep)
        h = self.ln_2(x)
        aux = None
        if hasattr(self, "moe"):
            h, aux = self.moe(h)
        else:
            h = F.gelu(self.mlp_fc(h), approximate="tanh")
            h = self.mlp_proj(h)
        return x + _dropout(h, self.dropout, keep), aux


class GPT2DoubleHeads(nn.Module):
    def __init__(self, vocab_size: int = 50257, n_positions: int = 1024,
                 n_embd: int = 768, n_layer: int = 12, n_head: int = 12,
                 dropout: float = 0.1, attn_impl: str = "dense",
                 seq_group=None, model_group=None, n_experts: int = 0,
                 moe_every: int = 2, expert_group=None,
                 moe_dispatch: str = "dense",
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        assert attn_impl in ATTN_IMPLS, attn_impl
        assert (attn_impl == "dense") == (seq_group is None), \
            "ring / ulysses attention needs a seq group, dense none"
        if attn_impl != "dense" and model_group is not None:
            # ring attention is per head, so it composes with the model
            # axis's head slices; Ulysses all-to-alls the heads over seq
            assert attn_impl == "ring", (
                "tensor parallelism composes with sequence parallelism "
                "only for attn_impl='ring' (ulysses shards heads over the "
                "seq axis, conflicting with model-axis head slicing)")
        if expert_group is not None:
            assert n_experts > 0, "expert_axis requires n_experts > 0"
        self.config = GPT2Config(vocab_size, n_positions, n_embd, n_layer,
                                 n_head, dropout)
        self.vocab_size = vocab_size
        self.n_layer = n_layer
        self.n_head = n_head
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.seq_group = seq_group
        self.model_group = model_group
        self.expert_group = expert_group
        self.n_experts = n_experts
        self.moe_every = moe_every
        self.wte = Embed(vocab_size, n_embd)
        self.wpe = Embed(n_positions, n_embd)
        for i in range(n_layer):
            moe = self.is_moe_block(i)
            setattr(self, f"h{i}", Block(
                n_embd, n_head, dropout, attn_impl, seq_group, model_group,
                n_experts=n_experts if moe else 0,
                expert_group=expert_group if moe else None,
                moe_dispatch=moe_dispatch,
                moe_capacity_factor=moe_capacity_factor))
        self.ln_f = LayerNorm(n_embd)
        self.mc_head = nn.Linear(n_embd, 1)

    def is_moe_block(self, i: int) -> bool:
        """Block ``i`` carries an MoE MLP: ``n_experts > 0`` and ``i %
        moe_every == moe_every - 1`` (GShard's every other layer)."""
        return self.n_experts > 0 and i % self.moe_every == \
            self.moe_every - 1

    @property
    def moe_blocks(self):
        """The indices of the MoE blocks."""
        return [i for i in range(self.n_layer) if self.is_moe_block(i)]

    def initial_model_state(self):
        """GPT-2 carries no model state."""
        return {}

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator``: ``wte`` and every
        dense kernel N(0, 0.02), ``wpe`` N(0, 0.01), biases 0, LayerNorm
        scales 1. (The two frameworks draw different numbers from one
        seed; weights cross through ``convert.py``.)"""
        for name, p in self.named_parameters():
            if name == "wpe.embedding":
                std = 0.01
            elif name == "wte.embedding" or name.endswith(".weight") or \
                    name.rsplit(".", 1)[-1] in ("router", "w_fc", "w_proj"):
                std = 0.02
            else:
                p.fill_(1.0 if name.endswith(".scale") else 0.0)
                continue
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    def dropout_shapes(self, n_seq: int, seq_len: int):
        """The shapes of the keep masks one forward of ``n_seq`` sequences
        of ``seq_len`` tokens (the local slice under sequence parallelism)
        draws, in call order: ``(embedding, [block 0's, block 1's,
        ...])``, a block's being its attention probabilities (dense
        attention only; this rank's local heads under tensor parallelism)
        and its two residual branches."""
        c = self.config
        tok = (n_seq, seq_len, c.n_embd)
        nm = self.model_group.size if self.model_group is not None else 1
        att = ([(n_seq, c.n_head // nm, seq_len, seq_len)]
               if self.attn_impl == "dense" else [])
        return tok, [att + [tok, tok] for _ in range(c.n_layer)]

    def dropout_numel(self, n_seq: int, seq_len: int) -> int:
        """Keep-mask elements one forward draws (``dropout_shapes``)."""
        emb, blocks = self.dropout_shapes(n_seq, seq_len)
        return int(np.prod(emb)) + sum(int(np.prod(sh)) for blk in blocks
                                       for sh in blk)

    def forward(self, input_ids, token_type_ids=None, mc_token_ids=None,
                dropout=None, return_aux: bool = False):
        """``input_ids``: ``(..., T)`` integer ids; ``token_type_ids`` the
        same shape; ``mc_token_ids``: ``(...,)`` the classification token's
        position. ``dropout``: a keep-mask source (``GeneratorKeep`` /
        ``MaskKeep``) for the train forward, None for eval.

        Returns ``(lm_logits (..., T, vocab), mc_logits (...,))``
        (``mc_logits`` None without ``mc_token_ids``), and with
        ``return_aux`` the MoE layers' aux losses ``(n_moe_blocks,)``
        third."""
        orig_shape = input_ids.shape
        T = orig_shape[-1]
        flat_ids = input_ids.reshape(-1, T)
        B = flat_ids.shape[0]
        sp = self.attn_impl != "dense"
        # the global positions of this rank's slice of the sequence
        pos0 = self.seq_group.rank * T if sp else 0
        pos = pos0 + torch.arange(T, device=input_ids.device)
        x = self.wte(flat_ids) + self.wpe(pos)[None]
        if token_type_ids is not None:
            x = x + self.wte(token_type_ids.reshape(-1, T))
        x = _dropout(x, self.dropout, dropout)
        mask = None if sp else torch.tril(torch.ones(
            (T, T), dtype=torch.bool, device=input_ids.device))[None, None]
        auxes = []
        for i in range(self.n_layer):
            x, aux = getattr(self, f"h{i}")(x, mask, dropout)
            if aux is not None:
                auxes.append(aux)
        x = self.ln_f(x)
        lm_logits = self.wte.attend(x)  # weight-tied LM head
        mc_logits = None
        if mc_token_ids is not None:
            flat_mc = mc_token_ids.reshape(-1).to(torch.int64)
            local = flat_mc - pos0
            safe = torch.clamp(local, 0, T - 1) if sp else local
            cls_h = torch.gather(
                x, 1, safe[:, None, None].expand(B, 1, x.shape[-1]))[:, 0]
            mc = self.mc_head(cls_h)[..., 0]
            if sp:
                # the token lives on one rank: the head's scalar output,
                # masked to that rank, summed over the group (identity
                # backward: each rank's parameter gradients stay its part)
                in_range = (local >= 0) & (local < T)
                mc = psum_repct(mc * in_range.to(mc.dtype), self.seq_group)
            mc_logits = mc.reshape(orig_shape[:-1])
        lm_logits = lm_logits.reshape(tuple(orig_shape) + (self.vocab_size,))
        if return_aux:
            aux = (torch.stack(auxes) if auxes else
                   torch.zeros(0, device=lm_logits.device))
            return lm_logits, mc_logits, aux
        return lm_logits, mc_logits

    @staticmethod
    def jax_param_path(torch_name: str) -> Tuple[str, ...]:
        """``"h0.attn_qkv.weight"`` -> ``("h0", "attn_qkv", "kernel")``;
        ``"wte.embedding"`` and the LayerNorm leaves keep their names."""
        parts = torch_name.split(".")
        if parts[-1] == "weight":
            parts[-1] = "kernel"
        return tuple(parts)

    @staticmethod
    def jax_param_kind(torch_name: str) -> str:
        """``dense`` for the ``nn.Linear`` kernels, ``asis`` for the rest
        (embedding tables, biases, LayerNorm scales)."""
        return "dense" if torch_name.endswith(".weight") else "asis"


def resize_token_embeddings(params: dict, new_vocab_size: int,
                            generator: Optional[torch.Generator] = None
                            ) -> dict:
    """Grow ``wte`` to ``new_vocab_size`` rows, keeping the existing rows
    (the embedding resize after adding special tokens). ``params`` is a
    flax-style tree ``{"wte": {"embedding": (V, E)}, ...}`` of tensors or
    numpy arrays; the new rows are N(0, 0.02) drawn from ``generator``."""
    wte = params["wte"]["embedding"]
    if not isinstance(wte, torch.Tensor):
        wte = torch.from_numpy(np.array(wte))
    old, dim = wte.shape
    if new_vocab_size <= old:
        return params
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    extra = 0.02 * torch.randn((new_vocab_size - old, dim), generator=gen,
                               dtype=wte.dtype)
    out = dict(params)
    out["wte"] = {"embedding": torch.cat([wte, extra.to(wte.device)])}
    return out


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def _load_safetensors(path: str) -> dict:
    """Read a ``.safetensors`` file without the ``safetensors`` package:
    an 8-byte little-endian header length, a JSON header mapping each
    tensor's name to ``{dtype, shape, data_offsets}``, then the raw bytes.
    Returns ``{name: CPU tensor}`` (BF16 as ``torch.bfloat16``)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        buf = bytearray(f.read())
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[spec["dtype"]]
        lo, hi = spec["data_offsets"]
        if hi == lo:
            t = torch.empty(0, dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, offset=lo,
                                 count=(hi - lo) // torch.empty(
                                     (), dtype=dtype).element_size())
        out[name] = t.reshape(spec["shape"]).clone()
    return out


def _numpy_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy().copy()
    return np.array(x, np.float32)


def load_hf_gpt2(params_template: dict, checkpoint_dir: str):
    """HF GPT-2 weights from ``checkpoint_dir`` (``pytorch_model.bin``
    first, then ``model.safetensors``) in the flax layout of
    ``params_template`` (a flax-style tree, e.g. ``convert.flax_from_port``
    of the model's parameters): a tree of float32 numpy arrays, with every
    leaf HF has loaded and the others (``mc_head``) copied from the
    template. The loaded ``wte`` keeps HF's vocabulary
    (``resize_token_embeddings`` grows it). None when neither file
    exists; nothing is fetched."""
    candidates = [os.path.join(checkpoint_dir, f)
                  for f in ("pytorch_model.bin", "model.safetensors")]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        return None
    if path.endswith(".bin"):
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        state = _load_safetensors(path)

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else _numpy_f32(v)
                for k, v in tree.items()}

    out = copy(params_template)

    def put(node, key, name):
        arr = _numpy_f32(state[name])
        if name != "transformer.wte.weight" and \
                arr.shape != node[key].shape:
            raise ValueError(f"{name}: shape {arr.shape}, the model's leaf "
                             f"is {node[key].shape}")
        node[key] = arr

    put(out["wte"], "embedding", "transformer.wte.weight")
    put(out["wpe"], "embedding", "transformer.wpe.weight")
    n_layer = sum(1 for k in out if k.startswith("h") and k[1:].isdigit())
    moe_blocks = [i for i in range(n_layer) if "moe" in out[f"h{i}"]]
    if moe_blocks:
        print(f"load_hf_gpt2: blocks {moe_blocks} are MoE — their expert "
              f"MLPs have no HF equivalent and stay freshly initialized "
              f"(attention/LN weights still load)")
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        blk = out[f"h{i}"]
        for leaf, hf in (("ln_1", "ln_1"), ("ln_2", "ln_2")):
            put(blk[leaf], "scale", p + hf + ".weight")
            put(blk[leaf], "bias", p + hf + ".bias")
        for leaf, hf in (("attn_qkv", "attn.c_attn"),
                         ("attn_proj", "attn.c_proj"),
                         ("mlp_fc", "mlp.c_fc"),
                         ("mlp_proj", "mlp.c_proj")):
            if leaf not in blk:
                # an MoE block: its experts keep the template's values
                continue
            # Conv1D (in, out) is flax's kernel layout
            put(blk[leaf], "kernel", p + hf + ".weight")
            put(blk[leaf], "bias", p + hf + ".bias")
    put(out["ln_f"], "scale", "transformer.ln_f.weight")
    put(out["ln_f"], "bias", "transformer.ln_f.bias")
    return out
