"""GPT-2 with a language-model head and a multiple-choice head (the
double-heads model of the FetchSGD reference's ``gpt2_train.py``) in plain
PyTorch over flax-layout leaves.

Token, token-type (through the token table) and position embeddings,
embedding dropout, then ``n_layer`` pre-LN blocks: LayerNorm (epsilon
``layer_norm_epsilon``), one packed q|k|v projection, causal softmax
attention scaled by ``1/sqrt(head_dim)`` with dropout on the
probabilities, the output projection with dropout on the residual branch,
LayerNorm, an MLP of width ``4 n_embd`` with the tanh GELU and dropout on
its residual branch; a final LayerNorm, the LM head tied to the token
table, and the MC head (a linear to one logit) at ``mc_token_ids``.

Dropout keep masks come from ``keep(shape)`` in the forward's call order
(embeddings; then per block the attention probabilities and the two
residual branches); a kept value is ``x / (1 - p)``. ``dropout_masks``
draws them from the seed: for each client, one ``torch.rand`` of
``keep_numel`` values from a generator on the device seeded with the
program's seed plus one, kept where below ``1 - p`` (the port's round
draws its masks so, and a different draw order would be a different,
equally valid, run: see PERF.md).

The per-example loss is the token-mean next-token NLL over the example's
candidates and positions (label -1 ignored) plus the MC cross-entropy.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

# the traffic field whose per-client shape sizes the model's work
MAIN_FIELD = "input_ids"

_BLOCK = (("attn_proj", "bias"), ("attn_proj", "kernel"),
          ("attn_qkv", "bias"), ("attn_qkv", "kernel"),
          ("ln_1", "bias"), ("ln_1", "scale"), ("ln_2", "bias"),
          ("ln_2", "scale"), ("mlp_fc", "bias"), ("mlp_fc", "kernel"),
          ("mlp_proj", "bias"), ("mlp_proj", "kernel"))


def _dropout_rate(cfg) -> float:
    rates = {cfg["resid_pdrop"], cfg["embd_pdrop"], cfg["attn_pdrop"]}
    if len(rates) != 1:
        raise ValueError(f"one dropout rate expected, got {sorted(rates)}")
    return float(rates.pop())


def leaves(cfg):
    """``[(flax path, flax shape)]`` of the model's parameters."""
    C, V, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
    shapes = {("attn_proj", "bias"): (C,), ("attn_proj", "kernel"): (C, C),
              ("attn_qkv", "bias"): (3 * C,),
              ("attn_qkv", "kernel"): (C, 3 * C),
              ("ln_1", "bias"): (C,), ("ln_1", "scale"): (C,),
              ("ln_2", "bias"): (C,), ("ln_2", "scale"): (C,),
              ("mlp_fc", "bias"): (4 * C,), ("mlp_fc", "kernel"): (C, 4 * C),
              ("mlp_proj", "bias"): (C,),
              ("mlp_proj", "kernel"): (4 * C, C)}
    out = [((f"h{i}",) + leaf, shapes[leaf])
           for i in range(cfg["n_layer"]) for leaf in _BLOCK]
    return out + [(("ln_f", "bias"), (C,)), (("ln_f", "scale"), (C,)),
                  (("mc_head", "bias"), (1,)), (("mc_head", "kernel"), (C, 1)),
                  (("wpe", "embedding"), (P, C)),
                  (("wte", "embedding"), (V, C))]


def init_rule(path, shape, cfg):
    """Kernels and embeddings N(0, initializer_range), biases 0, LayerNorm
    scales 1."""
    if path[-1] in ("kernel", "embedding"):
        return ("normal", float(cfg["initializer_range"]))
    return ("const", 1.0 if path[-1] == "scale" else 0.0)


def _ln(x, params, name, eps):
    return F.layer_norm(x, (x.shape[-1],), params[name + ("scale",)],
                        params[name + ("bias",)], eps)


def _dense(x, params, name):
    return x @ params[name + ("kernel",)] + params[name + ("bias",)]


def forward(params, ids, token_types, mc_ids, keep, cfg):
    """``(lm_logits (N, T, V), mc_logits (N,))`` of ``N`` sequences."""
    N, T = ids.shape
    C, H = cfg["n_embd"], cfg["n_head"]
    hd = C // H
    eps = float(cfg["layer_norm_epsilon"])
    rate = _dropout_rate(cfg)

    def drop(x):
        if keep is None or rate == 0.0:
            return x
        return torch.where(keep(x.shape), x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    wte = params[("wte", "embedding")]
    x = wte[ids] + params[("wpe", "embedding")][:T][None] + wte[token_types]
    x = drop(x)
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                   device=ids.device))
    for i in range(cfg["n_layer"]):
        b = (f"h{i}",)
        q, k, v = _dense(_ln(x, params, b + ("ln_1",), eps), params,
                         b + ("attn_qkv",)).split(C, dim=-1)
        q, k, v = (t.reshape(N, T, H, hd).transpose(1, 2) for t in (q, k, v))
        att = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        att = torch.where(causal, att, torch.finfo(att.dtype).min)
        att = drop(torch.softmax(att, dim=-1))
        y = (att @ v).transpose(1, 2).reshape(N, T, C)
        x = x + drop(_dense(y, params, b + ("attn_proj",)))
        h = _dense(_ln(x, params, b + ("ln_2",), eps), params,
                   b + ("mlp_fc",))
        h = _dense(F.gelu(h, approximate="tanh"), params, b + ("mlp_proj",))
        x = x + drop(h)
    x = _ln(x, params, ("ln_f",), eps)
    lm = x @ wte.t()
    cls = x[torch.arange(N, device=x.device), mc_ids.long()]
    mc = _dense(cls, params, ("mc_head",))[:, 0]
    return lm, mc


def _seq_shape(batch):
    ids = batch["input_ids"]
    return ids.shape[:2], ids.shape[1] * ids.shape[2], ids.shape[-1]


def keep_numel(cfg, batch) -> int:
    """Keep-mask elements one client's forward takes: the embeddings and,
    per block, the attention probabilities and the two residual
    branches."""
    _, n_seq, T = _seq_shape(batch)
    C, H = cfg["n_embd"], cfg["n_head"]
    tok = n_seq * T * C
    return tok + cfg["n_layer"] * (n_seq * H * T * T + 2 * tok)


def dropout_masks(cfg, batch, generator):
    """``(W, keep_numel)`` keep masks, one ``torch.rand`` a client."""
    (W, _), _, _ = _seq_shape(batch)
    n = keep_numel(cfg, batch)
    keep_prob = 1.0 - _dropout_rate(cfg)
    return torch.stack([torch.rand(n, generator=generator,
                                   device=generator.device) < keep_prob
                        for _ in range(W)])


class _Keep:
    """The clients' flat masks, sliced in the forward's call order and
    stacked over the clients (the forward runs all clients' sequences as
    one batch, client-major)."""

    def __init__(self, masks, W):
        self.masks, self.W, self.off = masks, W, 0

    def __call__(self, shape):
        per = (shape[0] // self.W,) + tuple(shape[1:])
        n = math.prod(per)
        out = self.masks[:, self.off:self.off + n].reshape((self.W,) + per)
        self.off += n
        return out.reshape(shape)


def example_losses(params, batch, masks, cfg):
    """``(W, B)`` losses: ``batch`` holds ``input_ids``,
    ``token_type_ids``, ``lm_labels`` ``(W, B, C, T)``, ``mc_token_ids``
    ``(W, B, C)`` and ``mc_labels`` ``(W, B)``; ``masks`` the ``(W, n)``
    keep masks (None: no dropout)."""
    (W, B), n_seq, T = _seq_shape(batch)
    Cn = batch["input_ids"].shape[2]
    keep = None if masks is None else _Keep(masks, W)
    lm, mc = forward(params, batch["input_ids"].reshape(-1, T),
                     batch["token_type_ids"].reshape(-1, T),
                     batch["mc_token_ids"].reshape(-1), keep, cfg)
    if keep is not None:
        assert keep.off == masks.shape[1], (keep.off, masks.shape)
    labels = batch["lm_labels"].reshape(-1, T)[:, 1:].long()
    valid = labels != -1
    logits = lm[:, :-1]
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    nll = (nll * valid).reshape(W, B, Cn * (T - 1)).sum(-1)
    n_valid = valid.reshape(W, B, Cn * (T - 1)).sum(-1).clamp(min=1)
    mc_ce = F.cross_entropy(mc.reshape(W * B, Cn),
                            batch["mc_labels"].reshape(-1).long(),
                            reduction="none").reshape(W, B)
    return nll / n_valid + mc_ce


def train_flops(cfg, per_client_shape) -> float:
    """Model FLOPs of one example's forward and backward (its ``C``
    candidates of ``T`` tokens), counted from the shapes with nothing
    recomputed: per token and block the four projections ``2 x 12 C^2``
    and the attention scores and values ``4 T C`` (the dense causal
    product computes all T x T), and the tied LM head ``2 C V``; the
    backward twice the forward (the embeddings are trained, so even the
    first projection's input takes a gradient)."""
    Cn, T = int(per_client_shape[1]), int(per_client_shape[2])
    C, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    per_token = L * (24.0 * C * C + 4.0 * T * C) + 2.0 * C * V
    return 3.0 * per_token * Cn * T
