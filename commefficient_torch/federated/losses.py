"""Workload loss callbacks matching the worker contract: the port of
``commefficient_tpu/federated/losses.py`` (CV head).

``compute_loss(params, model_state, batch, rng, train) ->
(loss_sum, metric_sums, count, new_model_state)`` with sums over valid
(mask = 1) examples; ``params`` is the ``{torch_name: tensor}`` dict that
``torch.func.functional_call`` applies to the module.
"""

from __future__ import annotations

import torch
from torch.func import functional_call
from torch.nn import functional as F


def make_cv_losses(model: torch.nn.Module):
    """Returns ``(compute_loss_train, compute_loss_val)`` for an image
    classifier: cross-entropy + accuracy. The CV models of this slice have
    no dropout and no BatchNorm, so ``rng``, ``train`` and the model state
    pass through unused."""

    def compute(params, model_state, batch, rng, train):
        x = batch["inputs"]
        y = batch["targets"]
        mask = batch["mask"]
        logits = functional_call(model, params, (x,)).to(torch.float32)
        losses = F.cross_entropy(logits, y.to(torch.int64), reduction="none")
        correct = (torch.argmax(logits, dim=-1) == y).to(torch.float32)
        loss_sum = torch.sum(losses * mask)
        acc_sum = torch.sum(correct * mask)
        count = torch.sum(mask)
        return loss_sum, (acc_sum,), count, model_state

    return compute, compute
