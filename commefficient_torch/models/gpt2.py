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

Tensor, pipeline and expert parallelism are not ported (ROADMAP.md queue
1 item 7).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from commefficient_torch.ops.collectives import psum_repct

__all__ = ["GPT2Config", "GPT2DoubleHeads", "Block", "GeneratorKeep",
           "MaskKeep", "resize_token_embeddings", "load_hf_gpt2"]

LN_EPSILON = 1e-5


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


class Block(nn.Module):
    """Pre-LN transformer block: dense causal attention, or ring / Ulysses
    attention over ``seq_group`` (this rank's slice of the sequence, no
    attention-probs dropout)."""

    def __init__(self, n_embd: int, n_head: int, dropout: float,
                 attn_impl: str = "dense", seq_group=None):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.seq_group = seq_group
        self.ln_1 = LayerNorm(n_embd)
        self.attn_qkv = nn.Linear(n_embd, 3 * n_embd)
        self.attn_proj = nn.Linear(n_embd, n_embd)
        self.ln_2 = LayerNorm(n_embd)
        self.mlp_fc = nn.Linear(n_embd, 4 * n_embd)
        self.mlp_proj = nn.Linear(4 * n_embd, n_embd)

    def forward(self, x, mask, keep=None):
        h = self.ln_1(x)
        B, T, C = h.shape
        q, k, v = torch.split(self.attn_qkv(h), C, dim=-1)
        hd = C // self.n_head
        q = q.reshape(B, T, self.n_head, hd)
        k = k.reshape(B, T, self.n_head, hd)
        v = v.reshape(B, T, self.n_head, hd)
        if self.attn_impl == "dense":
            # a Python-float scale, as in flax (a bf16 forward stays bf16)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
                1.0 / float(np.sqrt(hd)))
            att = torch.where(mask, att, torch.finfo(att.dtype).min)
            att = torch.softmax(att, dim=-1)
            att = _dropout(att, self.dropout, keep)
            out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, C)
        else:
            # T is the local slice; the attention handles global causality
            from commefficient_torch.parallel.ring import ring_attention
            from commefficient_torch.parallel.ulysses import (
                ulysses_attention,
            )

            attn = {"ring": ring_attention,
                    "ulysses": ulysses_attention}[self.attn_impl]
            out = attn(q, k, v, self.seq_group, causal=True).reshape(B, T, C)
        x = x + _dropout(self.attn_proj(out), self.dropout, keep)
        h = self.mlp_fc(self.ln_2(x))
        h = F.gelu(h, approximate="tanh")
        return x + _dropout(self.mlp_proj(h), self.dropout, keep)


class GPT2DoubleHeads(nn.Module):
    def __init__(self, vocab_size: int = 50257, n_positions: int = 1024,
                 n_embd: int = 768, n_layer: int = 12, n_head: int = 12,
                 dropout: float = 0.1, attn_impl: str = "dense",
                 seq_group=None):
        super().__init__()
        assert attn_impl in ATTN_IMPLS, attn_impl
        assert (attn_impl == "dense") == (seq_group is None), \
            "ring / ulysses attention needs a seq group, dense none"
        self.config = GPT2Config(vocab_size, n_positions, n_embd, n_layer,
                                 n_head, dropout)
        self.vocab_size = vocab_size
        self.n_layer = n_layer
        self.n_head = n_head
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.seq_group = seq_group
        self.wte = Embed(vocab_size, n_embd)
        self.wpe = Embed(n_positions, n_embd)
        for i in range(n_layer):
            setattr(self, f"h{i}", Block(n_embd, n_head, dropout,
                                         attn_impl, seq_group))
        self.ln_f = LayerNorm(n_embd)
        self.mc_head = nn.Linear(n_embd, 1)

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
            elif name == "wte.embedding" or name.endswith(".weight"):
                std = 0.02
            else:
                p.fill_(1.0 if name.endswith(".scale") else 0.0)
                continue
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    def dropout_numel(self, n_seq: int, seq_len: int) -> int:
        """Keep-mask elements one forward of ``n_seq`` sequences of
        ``seq_len`` tokens (the local slice under sequence parallelism)
        draws: the embedding dropout, then per block the attention
        probabilities (dense attention only) and the two residual
        branches."""
        c = self.config
        tok = n_seq * seq_len * c.n_embd
        att = (n_seq * c.n_head * seq_len * seq_len
               if self.attn_impl == "dense" else 0)
        return tok + c.n_layer * (att + 2 * tok)

    def forward(self, input_ids, token_type_ids=None, mc_token_ids=None,
                dropout=None):
        """``input_ids``: ``(..., T)`` integer ids; ``token_type_ids`` the
        same shape; ``mc_token_ids``: ``(...,)`` the classification token's
        position. ``dropout``: a keep-mask source (``GeneratorKeep`` /
        ``MaskKeep``) for the train forward, None for eval.

        Returns ``(lm_logits (..., T, vocab), mc_logits (...,))``
        (``mc_logits`` None without ``mc_token_ids``)."""
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
        for i in range(self.n_layer):
            x = getattr(self, f"h{i}")(x, mask, dropout)
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
            # Conv1D (in, out) is flax's kernel layout
            put(blk[leaf], "kernel", p + hf + ".weight")
            put(blk[leaf], "bias", p + hf + ".bias")
    put(out["ln_f"], "scale", "transformer.ln_f.weight")
    put(out["ln_f"], "bias", "transformer.ln_f.bias")
    return out
