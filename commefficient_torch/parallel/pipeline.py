"""GPipe pipeline parallelism for GPT-2 over a ``stage`` axis of ranks: the
port of ``commefficient_tpu/parallel/pipeline.py`` (``pp_layer_ranges``,
``_auto_micro``, ``make_gpt2_pp_losses``).

As with tensor parallelism, the parameters stay full-shape and replicated
on every rank, so the flat vector, compression, checkpoints and the HF
loader never see the axis; only compute is split:

- the ``n_layer`` blocks fall into balanced contiguous ranges, one a
  stage (``pp_layer_ranges``), and each rank runs its own range alone
  (``models/gpt2.Block``, which carries the seq, model and expert groups:
  every member of such a group sits at the same stage, so the collectives
  inside a block are issued alike by all of them). The JAX package stacks
  the layers and gathers a range by the stage index only to keep one SPMD
  program; a process a rank needs none of that;
- each client batch is cut into ``n_micro`` microbatches
  (``_auto_micro``: the largest divisor of the example count no larger
  than ``n_micro``) and run on the GPipe clock: at tick ``t`` stage ``s``
  works on microbatch ``t - s``, and the activations hop stage -> stage +
  1 at the end of every one of the ``n_micro + n_stages - 1`` ticks
  (``_Hop``: ``ops/collectives.send_recv``, gloo's host staging
  included; its backward sends the cotangent back one stage; its
  ``vmap`` rule hops the whole batch of clients once). A stage skips the
  compute of a tick it has no microbatch for and hops zeros;
- stage 0 embeds (with the embedding dropout), the last stage runs
  ``ln_f``, the tied LM head, the per-example token NLL sums and the
  multiple-choice logit, so only small per-example values leave it: no
  ``(tokens x vocab)`` logits cross a rank;
- those values, zero on the other stages, are summed over the stage group
  with an identity backward (``ops/collectives.psum_repct``, after
  ``_batch_first`` gives every stage's batched value one layout), so the
  loss is replicated and its cotangent enters the pipeline on the last
  stage alone. Each parameter's gradient then lives on the stage that
  used it (the embeddings on stage 0, a block on its stage, ``ln_f``, the
  heads and ``wte``'s tied use on the last stage), and one plain sum over
  ``stage`` (``federated/worker.reconcile``) gives the dense gradient.

Collective uniformity under autograd: every rank must run the same hops,
forward and backward, in the same order. A hop's backward runs on a rank
only if its output reaches that rank's loss and its input reaches a
parameter leaf, so both are tied in without touching a value (``_Tie``:
the identity forward, zeros to the tied tensor backward): every hop's
input is tied to a parameter (stage 0's first hop and the later stages'
idle ticks start from zeros), stage 0 ties what it receives (always
zeros) into its embedding, an idle tick's zeros tie in what it received,
and the last hop's output is tied into the loss on every stage. The
hops' backwards then run on every stage in reverse tick order.

Dropout follows the dense loss (``federated/losses.py``): the pipelined
loss reads the masks the dense forward of the client's batch would draw,
in its call order (the embedding, then a block's attention probabilities
and two residual branches), from the same source: the fused client
phase's pre-drawn flat masks (``draw_rng`` is the dense loss's,
``losses.draw_keep_masks``), or a generator drawn in the dense forward's
order, every segment at its whole-batch shape (so the generator moves on
exactly as there). Each stage cuts out its layers' segments and each
microbatch's rows, so the pipelined round equals the dense round at any
dropout, up to float32 order. Under sequence parallelism each seq rank
draws its own (``seq_generator``); the model and expert ranks of a stage
draw alike.

Compositions, each on its own axis of the grid (``parallel/mesh.py``):
tensor parallelism (each stage's blocks slice heads and MLP columns over
``model``), sequence parallelism (the hops carry this rank's ``T / Q``
slice of every sequence; the last stage reads the pre-shifted labels and
masks its multiple-choice logit to the seq rank that holds the
classification token, and the three per-example values are summed over
``seq`` after the stage sum, as in the JAX package) and the MoE model
(its Switch MLPs in their stage's blocks; the aux summed over the active
ticks and the stage's MoE layers, then over ``stage``, divided by the
MoE layer count times the microbatch count: a per-microbatch estimator,
equal to the dense loss's whole-batch aux at one microbatch). An MoE
model needs every stage to run the same dense/MoE layer pattern, as the
JAX package asserts.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
from torch.func import functional_call
from torch.nn import functional as F

from commefficient_torch.federated.losses import (
    _cast_params,
    _mc_ce_acc,
    draw_keep_masks,
    dropout_source,
    lm_nll_sums,
)
from commefficient_torch.models.gpt2 import LN_EPSILON, MaskKeep, _dropout
from commefficient_torch.ops.collectives import psum_repct, send_recv
from commefficient_torch.parallel.mesh import STAGE_AXIS

__all__ = ["STAGE_AXIS", "pp_layer_ranges", "make_gpt2_pp_losses"]


def pp_layer_ranges(n_layer: int, n_stages: int):
    """Balanced contiguous layer ranges, one per stage; the first
    ``n_layer % n_stages`` stages take the extra layer."""
    assert 1 <= n_stages <= n_layer, \
        f"need 1 <= n_stages ({n_stages}) <= n_layer ({n_layer})"
    base, rem = divmod(n_layer, n_stages)
    ranges, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def _auto_micro(n_examples: int, n_micro: int) -> int:
    """Largest divisor of the example count that is <= n_micro, so odd
    validation batch sizes degrade to fewer microbatches instead of
    failing."""
    m = max(1, min(n_micro, n_examples))
    while n_examples % m:
        m -= 1
    return m


def _batch_first(x: torch.Tensor, dim: Optional[int], size: int
                 ) -> torch.Tensor:
    """A ``vmap`` rule's physical tensor with its batch axis first (an
    unbatched one expanded), so that ranks running different code send and
    sum one layout."""
    if dim is None:
        return x.expand((size,) + tuple(x.shape))
    return x.movedim(dim, 0)


class _BatchFirst(torch.autograd.Function):
    """The identity; under ``vmap`` its output has the batch axis first."""

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return ct

    @staticmethod
    def vmap(info, in_dims, x):
        return _batch_first(x, in_dims[0], info.batch_size), 0


class _Tie(torch.autograd.Function):
    """``a`` forward; backward, ``a``'s cotangent to ``a`` and zeros to
    ``b``: puts ``b`` on the backward path without touching a value."""

    @staticmethod
    def forward(a, b):
        return a.view_as(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        b = inputs[1]
        ctx.b_like = (b.shape, b.dtype, b.device)

    @staticmethod
    def backward(ctx, ct):
        shape, dtype, device = ctx.b_like
        return ct, torch.zeros(shape, dtype=dtype, device=device)

    @staticmethod
    def vmap(info, in_dims, a, b):
        return _Tie.apply(a, b), in_dims[0]


class _Hop(torch.autograd.Function):
    """One GPipe hop over the stage group: stage ``s`` sends its tensor to
    ``s + 1`` and returns what ``s - 1`` sent (zeros on stage 0; the last
    stage sends nothing). The backward sends the cotangent back one
    stage. The ``vmap`` rule hops the batch of clients once, batch axis
    first on every stage."""

    @staticmethod
    def forward(x, cg):
        r, n = cg.rank, cg.size
        got = send_recv(x, cg, r + 1 if r < n - 1 else None,
                        r - 1 if r > 0 else None)
        return torch.zeros_like(x) if got is None else got

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cg = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        cg = ctx.cg
        r, n = cg.rank, cg.size
        got = send_recv(ct, cg, r - 1 if r > 0 else None,
                        r + 1 if r < n - 1 else None)
        return (torch.zeros_like(ct) if got is None else got), None

    @staticmethod
    def vmap(info, in_dims, x, cg):
        return _Hop.apply(_batch_first(x, in_dims[0], info.batch_size),
                          cg), 0


def _all_masks(model, source, rows: int, T: int, device):
    """The dense forward's keep masks at their whole-batch shapes (the
    structure of ``GPT2DoubleHeads.dropout_shapes``): cut in call order
    from a flat tensor, or drawn in call order from a generator."""
    keep_prob = 1.0 - float(model.dropout)
    emb, blocks = model.dropout_shapes(rows, T)
    off = 0

    def take(shape):
        nonlocal off
        if isinstance(source, torch.Generator):
            return torch.rand(shape, generator=source,
                              device=device) < keep_prob
        n = math.prod(shape)
        out = source[off:off + n].reshape(shape)
        off += n
        return out

    out = (take(emb), [[take(sh) for sh in blk] for blk in blocks])
    if not isinstance(source, torch.Generator):
        assert off == source.shape[-1], (off, source.shape[-1])
    return out


def _cut(*masks, rows: slice) -> MaskKeep:
    """A block's (or the embedding's) keep masks cut to a microbatch's
    rows, handed out in call order."""
    return MaskKeep(torch.cat([m[rows].reshape(-1) for m in masks]))


def make_gpt2_pp_losses(model: torch.nn.Module, stage_group,
                        n_micro: int = 4, lm_coef: float = 1.0,
                        mc_coef: float = 1.0,
                        compute_dtype: Optional[torch.dtype] = None,
                        moe_aux_coef: float = 0.0):
    """The pipelined twin of ``federated/losses.make_gpt2_losses``: the
    same ``(loss_sum, metric_sums, count, model_state)`` contract and
    math, the same ``draw_rng``, run over ``stage_group`` (a
    ``parallel/mesh.ClientGroup`` along the ``stage`` axis) on the GPipe
    clock of the module docstring. ``model``'s seq, model and expert groups
    (its attention, head and MLP slices, its experts) carry over; every
    rank of the stage group calls the callbacks on the same batch.
    ``compute_dtype`` (``--bf16``) casts the parameter views, and the
    hops carry that dtype."""
    S, s_idx = stage_group.size, stage_group.rank
    ranges = pp_layer_ranges(model.n_layer, S)
    lo, hi = ranges[s_idx]
    is_moe = [model.is_moe_block(layer) for layer in range(model.n_layer)]
    n_moe_layers = sum(is_moe)
    if n_moe_layers:
        patterns = {tuple(is_moe[a:b]) for a, b in ranges}
        assert len(patterns) == 1, (
            f"MoE pipeline needs every stage to run the same dense/MoE "
            f"layer pattern (moe_every={model.moe_every}), got "
            f"{sorted(patterns)} over ranges {ranges}; use n_layer "
            f"({model.n_layer}) divisible by n_stages ({S}) with "
            f"the per-stage range a multiple of moe_every")
    seq_group = model.seq_group
    sp = model.attn_impl != "dense"
    first, last = s_idx == 0, s_idx == S - 1
    with_aux = bool(moe_aux_coef) and n_moe_layers > 0
    dt = compute_dtype or torch.float32
    n_embd = model.config.n_embd

    def _pipeline(params, batch, rng, train):
        # the tie that keeps every hop on the backward path (the module
        # docstring): a one-element leaf
        anchor = params["mc_head.bias"]
        if compute_dtype is not None:
            params = _cast_params(params, compute_dtype)
        ids = batch["input_ids"]
        E0, C, T = ids.shape  # T: this rank's slice under seq parallelism
        nm = _auto_micro(E0, n_micro)
        me = E0 // nm
        R = me * C  # transformer rows a microbatch
        dev = ids.device
        source = dropout_source(model, seq_group, rng, train)
        masks = (None if source is None
                 else _all_masks(model, source, E0 * C, T, dev))
        wte, wpe = params["wte.embedding"], params["wpe.embedding"]
        pos0 = seq_group.rank * T if sp else 0
        causal = None if sp else torch.tril(torch.ones(
            (T, T), dtype=torch.bool, device=dev))[None, None]
        blocks = {}
        for layer in range(lo, hi):
            pre = f"h{layer}."
            blocks[layer] = {k[len(pre):]: v for k, v in params.items()
                             if k.startswith(pre)}
        flat_ids = ids.reshape(E0 * C, T)
        flat_tt = batch["token_type_ids"].reshape(E0 * C, T)
        labels = batch["lm_labels_shifted" if sp else "lm_labels"]
        mc_ids = batch["mc_token_ids"]
        heads, aux = [], None

        def embed(rows):
            x = F.embedding(flat_ids[rows], wte) + F.embedding(
                pos0 + torch.arange(T, device=dev), wpe)[None]
            x = x + F.embedding(flat_tt[rows], wte)
            keep = None if masks is None else _cut(masks[0], rows=rows)
            return _dropout(x, model.dropout, keep)

        def head(x, m):
            ex = slice(m * me, (m + 1) * me)
            x = F.layer_norm(x, (n_embd,), params["ln_f.scale"],
                             params["ln_f.bias"], LN_EPSILON)
            lm_logits = F.linear(x, wte).reshape(me, C, T, -1)
            nll, nv = lm_nll_sums(lm_logits, labels[ex], sp)
            local = mc_ids[ex].reshape(R).to(torch.int64) - pos0
            safe = torch.clamp(local, 0, T - 1) if sp else local
            cls = torch.gather(x, 1, safe[:, None, None].expand(
                R, 1, n_embd))[:, 0]
            mc = F.linear(cls, params["mc_head.weight"],
                          params["mc_head.bias"])[..., 0].to(torch.float32)
            if sp:
                # the classification token lives on one seq rank: the
                # masked logit keeps each rank's gradient its part
                mc = mc * ((local >= 0) & (local < T)).to(torch.float32)
            return nll, nv.to(torch.float32), mc.reshape(me, C)

        buf = None
        for t in range(nm + S - 1):
            m = t - s_idx  # this stage's microbatch at tick t
            if 0 <= m < nm:
                rows = slice(m * R, (m + 1) * R)
                if first:
                    x = embed(rows).to(dt)
                    if buf is not None:
                        x = _Tie.apply(x, buf)
                else:
                    x = buf
                for layer in range(lo, hi):
                    keep = None if masks is None else _cut(
                        *masks[1][layer], rows=rows)
                    x, a = functional_call(getattr(model, f"h{layer}"),
                                           blocks[layer], (x, causal, keep))
                    if with_aux and train and a is not None:
                        aux = a if aux is None else aux + a
                if last:
                    heads.append(head(x, m))
                send = x
            else:
                # an idle tick hops zeros, tied to what it received (made
                # from the batch, so that they are batched under vmap)
                send = torch.zeros_like(flat_ids[:R, :, None],
                                        dtype=dt).expand(R, T, n_embd)
                if buf is not None:
                    send = _Tie.apply(send, buf)
            buf = _Hop.apply(_Tie.apply(send, anchor), stage_group)

        # this stage's per-example values (zeros but on the last stage),
        # tied to the last hop, summed over the stage group
        mask = batch["mask"]
        if last:
            nll, nv, mc = (torch.cat(v) for v in zip(*heads))
        else:
            nll = torch.zeros_like(mask, dtype=torch.float32)
            nv = torch.zeros_like(mask, dtype=torch.float32)
            mc = torch.zeros_like(mc_ids, dtype=torch.float32)
        parts = [nll, nv, mc.reshape(E0 * C)]
        if with_aux and train:
            parts.append(aux.to(torch.float32).reshape(1))
        local = _Tie.apply(torch.cat(parts), buf)
        total = psum_repct(_BatchFirst.apply(local), stage_group)
        head_vals = total[:E0 * (2 + C)]
        if sp:
            # each seq rank holds its tokens' sums and the owning rank's
            # logit: one more identity-backward sum replicates them
            head_vals = psum_repct(head_vals, seq_group)
        nll, nv = head_vals[:E0], head_vals[E0:2 * E0]
        mc_logits = head_vals[2 * E0:].reshape(E0, C)
        aux_total = (total[-1] / (n_moe_layers * nm)
                     if with_aux and train else None)
        return nll / torch.clamp(nv, min=1.0), mc_logits, aux_total

    def compute_train(params, model_state, batch, rng, train):
        lm_nll, mc_logits, aux_total = _pipeline(params, batch, rng, train)
        mc_ce, _ = _mc_ce_acc(mc_logits, batch["mc_labels"])
        mask = batch["mask"]
        loss_sum = torch.sum((lm_coef * lm_nll + mc_coef * mc_ce) * mask)
        if aux_total is not None:
            # the dense loss's example-count weighting
            loss_sum = loss_sum + moe_aux_coef * aux_total * torch.sum(mask)
        return loss_sum, (), torch.sum(mask), model_state

    if model.dropout != 0.0:
        compute_train.draw_rng = partial(draw_keep_masks, model, seq_group)

    def compute_val(params, model_state, batch, rng, train):
        lm_nll, mc_logits, _ = _pipeline(params, batch, None, False)
        _, acc = _mc_ce_acc(mc_logits, batch["mc_labels"])
        mask = batch["mask"]
        return (torch.sum(lm_nll * mask), (torch.sum(acc * mask),),
                torch.sum(mask), model_state)

    return compute_train, compute_val
