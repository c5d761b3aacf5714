"""Workload loss callbacks matching the worker contract: the port of
``commefficient_tpu/federated/losses.py`` (the CV head and GPT-2's double
heads).

``compute_loss(params, model_state, batch, rng, train) ->
(loss_sum, metric_sums, count, new_model_state)`` with sums over valid
(mask = 1) examples; ``params`` is the ``{torch_name: tensor}`` dict that
``torch.func.functional_call`` applies to the module.

``rng`` is the train forward's source of dropout masks: a
``torch.Generator`` (the per-client path hands the round's generator
in), or a flat boolean tensor of keep masks drawn beforehand by the
loss's ``draw_rng(generator, microbatch)`` (the fused client phase draws
one per client and microbatch before its ``torch.func.vmap``, whose
``randomness`` cannot take an explicit generator). A loss without
dropout has no ``draw_rng`` and ignores ``rng``.

GPT-2's losses under sequence parallelism (``seq_group``) see this rank's
slice of the sequence: the next-token targets come pre-shifted over the
global sequence (``lm_labels_shifted``, the collate's ``emit_shifted``),
the per-example NLL sum is summed over the group through
``ops/collectives.psum_repct`` (identity backward: the loss is replicated
over the group) and the valid-token count through a plain sum, so the
loss is the dense one on every rank and each rank's gradient is its
slice's part. Each seq rank draws its own dropout masks, from a generator
seeded by the round's generator and its seq index (``seq_generator``).
The ranks of the ``model`` and ``expert`` axes draw the same masks (the
same generator), as the JAX package's ranks draw from one key.

``moe_aux_coef`` (``--moe_aux_coef``, with an MoE model): the train loss
adds ``moe_aux_coef`` times the mean over the MoE layers of their Switch
aux losses (``forward(..., return_aux=True)``) times the client's
valid-example count, so the aux enters the data-weighted aggregation as
the per-example terms do; the val metrics stay the NLL and accuracy.
"""

from __future__ import annotations

import hashlib
from functools import partial
from typing import Optional

import torch
from torch.func import functional_call
from torch.nn import functional as F

from commefficient_torch.models.gpt2 import GeneratorKeep, MaskKeep
from commefficient_torch.ops.collectives import psum_repct


def make_cv_losses(model: torch.nn.Module,
                   compute_dtype: Optional[torch.dtype] = None):
    """Returns ``(compute_loss_train, compute_loss_val)`` for an image
    classifier: cross-entropy + accuracy. The CV models have no dropout,
    so ``rng`` passes through unused. Without BatchNorm the model state
    passes through; with it (``model.do_batchnorm``) the train call
    normalizes with the batch's statistics and returns the updated
    running statistics as ``new_model_state``, and the val call normalizes
    with the running statistics and returns them unchanged (flax's
    ``mutable=["batch_stats"]`` train apply, and its eval apply).

    ``compute_dtype=torch.bfloat16`` (``--bf16``) casts the parameter
    views and the images going in; the logits come back to float32 before
    the cross-entropy, the running statistics to float32, and the
    gradient reaches the float32 flat vector through the casts."""
    has_bn = bool(getattr(model, "do_batchnorm", False))

    def compute(params, model_state, batch, rng, train):
        x = batch["inputs"]
        y = batch["targets"]
        mask = batch["mask"]
        if compute_dtype is not None:
            params = _cast_params(params, compute_dtype)
            x = x.to(compute_dtype)
        if has_bn:
            logits, new_state = functional_call(model, params,
                                                (x, model_state, train))
            new_state = {k: v.to(torch.float32)
                         for k, v in new_state.items()}
        else:
            logits = functional_call(model, params, (x,))
            new_state = model_state
        logits = logits.to(torch.float32)
        losses = F.cross_entropy(logits, y.to(torch.int64), reduction="none")
        correct = (torch.argmax(logits, dim=-1) == y).to(torch.float32)
        loss_sum = torch.sum(losses * mask)
        acc_sum = torch.sum(correct * mask)
        count = torch.sum(mask)
        return loss_sum, (acc_sum,), count, new_state

    return compute, compute


def _cast_params(params, dtype):
    """The float32 parameter views in the compute dtype (``--bf16``); the
    gradient comes back through the cast in float32."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def _mc_ce_acc(mc_logits, mc_labels):
    """Multiple-choice cross-entropy and accuracy over the candidate
    axis."""
    logp = torch.log_softmax(mc_logits, dim=-1)
    labels = mc_labels.to(torch.int64)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    acc = (torch.argmax(mc_logits, dim=-1) == labels).to(torch.float32)
    return ce, acc


def seq_generator(generator: torch.Generator, index: int
                  ) -> torch.Generator:
    """A generator of this seq rank's own: seeded from a hash of
    ``generator``'s state and the seq index ``index`` (host-only: no wait
    on the device); ``generator`` then moves on by one draw, on every seq
    rank alike, so what it draws next (DP noise) stays replicated."""
    base = hashlib.sha256(generator.get_state().numpy().tobytes() +
                          b"seq" + int(index).to_bytes(8, "little")).digest()
    gen = torch.Generator(device=generator.device).manual_seed(
        int.from_bytes(base[:8], "little") >> 1)
    torch.rand(1, generator=generator, device=generator.device)
    return gen


def lm_nll_sums(lm_logits, labels, shifted: bool):
    """Per-example sums of the next-token NLL and the valid-target count
    over the last two axes (candidates, positions): ``logsumexp`` minus
    the gathered logit, accumulated in float32, so no ``(..., V)``
    log-prob tensor is formed. ``shifted``: the targets are already
    shifted (``lm_labels_shifted``: position t's target is token t + 1);
    else position t predicts ``labels[t + 1]`` and the last position
    predicts nothing. Label -1 is ignored."""
    if shifted:
        logits = lm_logits
        labels = labels.to(torch.int64)
    else:
        logits = lm_logits[..., :-1, :]
        labels = labels[..., 1:].to(torch.int64)
    valid = labels != -1
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0].to(
        torch.float32)
    tok_nll = (lse - picked) * valid
    return tok_nll.sum(dim=(-2, -1)), valid.sum(dim=(-2, -1))


def _lm_nll_per_example(lm_logits, batch, seq_group=None):
    """Per-example token-mean NLL of the next token (position t predicts
    t + 1; label -1 is ignored), as the JAX package takes it (a documented
    deviation from the reference's batch-wide token mean, identical when
    the examples have equal valid-token counts). With ``seq_group`` the
    logits are this rank's slice, the targets ``lm_labels_shifted``
    (shifted over the global sequence), and the sums run over the
    group."""
    if seq_group is not None:
        nll_sum, n_valid = lm_nll_sums(lm_logits,
                                       batch["lm_labels_shifted"], True)
        # the loss is replicated over the group, so the sum's backward is
        # the identity; the count carries no gradient
        nll_sum = psum_repct(nll_sum, seq_group)
        n_valid = psum_repct(n_valid, seq_group)
    else:
        nll_sum, n_valid = lm_nll_sums(lm_logits, batch["lm_labels"], False)
    return nll_sum / torch.clamp(n_valid, min=1)


def dropout_source(model, seq_group, rng, train):
    """Where a GPT-2 train forward takes its keep masks: None (eval, or no
    dropout), the generator to draw them from (under sequence parallelism
    this seq rank's own, ``seq_generator``), or the flat masks drawn
    beforehand (``draw_keep_masks``)."""
    if not train or model.dropout == 0.0:
        return None
    if isinstance(rng, torch.Generator):
        return rng if seq_group is None else seq_generator(rng,
                                                           seq_group.rank)
    if isinstance(rng, torch.Tensor):
        return rng
    raise ValueError("the GPT-2 train forward draws dropout masks: pass "
                     "a torch.Generator or pre-drawn keep masks as rng")


def draw_keep_masks(model, seq_group, generator: torch.Generator,
                    micro) -> torch.Tensor:
    """The flat keep masks of one microbatch for each client: ``(W, n)``
    booleans for ``micro`` with a leading client axis, ``n =
    model.dropout_numel`` (under sequence parallelism this rank's masks
    for its slice, from ``seq_generator``)."""
    ids = micro["input_ids"]
    W, T = ids.shape[0], ids.shape[-1]
    if seq_group is not None:
        generator = seq_generator(generator, seq_group.rank)
    n = model.dropout_numel(ids[0].numel() // T, T)
    keep_prob = 1.0 - float(model.dropout)
    return torch.stack([
        torch.rand(n, generator=generator, device=ids.device) < keep_prob
        for _ in range(W)])


def make_gpt2_losses(model: torch.nn.Module, lm_coef: float = 1.0,
                     mc_coef: float = 1.0,
                     compute_dtype: Optional[torch.dtype] = None,
                     seq_group=None, moe_aux_coef: float = 0.0):
    """GPT-2 double-heads losses (the JAX package's ``make_gpt2_losses``).
    ``seq_group``: the model's ``seq`` group under sequence parallelism
    (the module docstring), None for the dense model. Train: ``lm_coef * lm_nll + mc_coef * mc_ce`` per
    example, summed under the mask, with no metrics. Val: ``(nll, (mc
    accuracy,))`` sums; perplexity is ``exp(mean nll)``, taken by the entry
    point. ``compute_dtype=torch.bfloat16`` (``--bf16``) casts the
    parameter views of the float32 flat vector before the forward; the LM
    logits stay in that dtype (the NLL accumulates in float32), the MC
    logits come back to float32.

    The train loss carries ``draw_rng(generator, micro)``: the flat keep
    masks of one microbatch for each client, ``(W, n)`` booleans for
    ``micro`` with a leading client axis (under sequence parallelism this
    rank's masks for its slice, from ``seq_generator``)."""
    keep_prob = 1.0 - float(model.dropout)
    assert (seq_group is None) == (getattr(model, "seq_group", None)
                                   is None), \
        "the loss and the model must share the seq group"
    # the aux is collected only where it enters the loss
    with_aux = bool(moe_aux_coef) and getattr(model, "n_experts", 0) > 0

    def _forward(params, batch, keep, aux=False):
        if compute_dtype is not None:
            params = _cast_params(params, compute_dtype)
        out = functional_call(
            model, params, (batch["input_ids"],),
            {"token_type_ids": batch["token_type_ids"],
             "mc_token_ids": batch["mc_token_ids"], "dropout": keep,
             "return_aux": aux})
        return (out[0], out[1].to(torch.float32)) + tuple(out[2:])

    def _keep_source(rng, train):
        src = dropout_source(model, seq_group, rng, train)
        if isinstance(src, torch.Generator):
            return GeneratorKeep(src, keep_prob)
        return None if src is None else MaskKeep(src)

    def compute_train(params, model_state, batch, rng, train):
        keep = _keep_source(rng, train)
        out = _forward(params, batch, keep, aux=with_aux)
        lm_logits, mc_logits = out[:2]
        if isinstance(keep, MaskKeep):
            keep.check_consumed()
        lm_nll = _lm_nll_per_example(lm_logits, batch, seq_group)
        mc_ce, _ = _mc_ce_acc(mc_logits, batch["mc_labels"])
        mask = batch["mask"]
        loss_sum = torch.sum((lm_coef * lm_nll + mc_coef * mc_ce) * mask)
        if with_aux:
            # the mean over MoE layers (the JAX package's deliberate
            # deviation from Switch's sum), weighted by the valid examples
            aux = out[2]
            loss_sum = loss_sum + moe_aux_coef * (
                torch.sum(aux) / aux.shape[0]) * torch.sum(mask)
        return loss_sum, (), torch.sum(mask), model_state

    if model.dropout != 0.0:
        compute_train.draw_rng = partial(draw_keep_masks, model, seq_group)

    def compute_val(params, model_state, batch, rng, train):
        lm_logits, mc_logits = _forward(params, batch, None)[:2]
        lm_nll = _lm_nll_per_example(lm_logits, batch, seq_group)
        _, acc = _mc_ce_acc(mc_logits, batch["mc_labels"])
        mask = batch["mask"]
        return (torch.sum(lm_nll * mask), (torch.sum(acc * mask),),
                torch.sum(mask), model_state)

    return compute_train, compute_val
