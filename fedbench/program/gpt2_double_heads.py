"""The port's GPT-2 double heads and its losses for a
``gpt2_double_heads`` configuration."""

import torch

from commefficient_torch.federated.losses import make_gpt2_losses
from commefficient_torch.models import GPT2DoubleHeads


def build(cfg):
    rates = {cfg["resid_pdrop"], cfg["embd_pdrop"], cfg["attn_pdrop"]}
    if len(rates) != 1:
        raise ValueError("the port's GPT-2 takes one dropout rate")
    with torch.device("meta"):
        model = GPT2DoubleHeads(
            vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
            n_embd=cfg["n_embd"], n_layer=cfg["n_layer"],
            n_head=cfg["n_head"], dropout=rates.pop())
    train_loss, val_loss = make_gpt2_losses(model)
    return model, train_loss, val_loss
