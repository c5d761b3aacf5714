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
    classifier: cross-entropy + accuracy. The CV models have no dropout,
    so ``rng`` passes through unused. Without BatchNorm the model state
    passes through; with it (``model.do_batchnorm``) the train call
    normalizes with the batch's statistics and returns the updated
    running statistics as ``new_model_state``, and the val call normalizes
    with the running statistics and returns them unchanged (flax's
    ``mutable=["batch_stats"]`` train apply, and its eval apply)."""
    has_bn = bool(getattr(model, "do_batchnorm", False))

    def compute(params, model_state, batch, rng, train):
        x = batch["inputs"]
        y = batch["targets"]
        mask = batch["mask"]
        if has_bn:
            logits, new_state = functional_call(model, params,
                                                (x, model_state, train))
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
