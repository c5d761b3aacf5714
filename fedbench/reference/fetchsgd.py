"""The federated round of the FetchSGD paper's training loop, in plain
PyTorch over the flat vector.

Client phase: the gradient of the sum over the clients' masked example
losses, plus weight decay ``(wd / W) * (number of examples) * w``, over
the number of examples (the data-weighted mean of the clients'
gradients). Server phase by mode:

- ``sketch`` (FetchSGD, virtual momentum and virtual error): the
  gradient's table ``S``; ``V = S + rho V``; ``E = E + V``; the update
  ``u`` is the top-k of the median-of-rows estimates of ``E``; ``E`` and
  ``V`` are zeroed at the nonzero cells of the sketch of ``u``;
- ``uncompressed``: ``V = g + rho V``, ``u = V``.

Then ``w = w - lr u``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from fedbench.reference.sketch import CountSketch, topk


class Round:
    """A reference run of a cell: the model module (``model``), its
    configuration, the recipe (mode, momentum, k, sketch, weight decay,
    lr), the flat layout and the device."""

    def __init__(self, model, cfg: dict, recipe: dict, layout, seed: int,
                 device, dropout_seed: Optional[int] = None):
        self.model, self.cfg, self.recipe = model, cfg, recipe
        self.layout = layout
        self.device = torch.device(device)
        self.mode = recipe["mode"]
        if self.mode not in ("sketch", "uncompressed"):
            raise ValueError(f"no reference for mode {self.mode!r}")
        if self.mode == "sketch" and recipe["error_type"] != "virtual":
            raise ValueError("the sketch reference is FetchSGD's virtual "
                             "error")
        self.sketch = (CountSketch(layout.d, recipe["num_cols"],
                                   recipe["num_rows"], seed, self.device)
                       if self.mode == "sketch" else None)
        shape = ((self.sketch.r, self.sketch.c_pad) if self.sketch
                 else (layout.d,))
        self.velocity = torch.zeros(shape, device=self.device)
        self.error = torch.zeros(shape, device=self.device)
        self.gen = (torch.Generator(device=self.device).manual_seed(
            int(dropout_seed)) if dropout_seed is not None else None)

    def client_phase(self, w: torch.Tensor, batch: Dict[str, torch.Tensor],
                     drop_clients: int = 0):
        """``(g (d,), per-client mean losses (W,))``. ``drop_clients``
        leaves the last that many clients out (their losses read 0): the
        half-batch fault."""
        W = batch["mask"].shape[0]
        masks = None
        if self.model.keep_numel(self.cfg, batch):
            masks = self.model.dropout_masks(self.cfg, batch, self.gen)
        leaves = [t.detach().requires_grad_(True)
                  for t in self.layout.split(w).values()]
        params = dict(zip(self.layout.paths, leaves))
        losses = self.model.example_losses(params, batch, masks, self.cfg)
        mask = batch["mask"].float()
        if drop_clients:
            mask = mask.clone()
            mask[W - drop_clients:] = 0
        counts = mask.sum(1)
        total = (losses * mask).sum()
        grads = torch.autograd.grad(total, leaves)
        g = torch.cat([x.reshape(-1) for x in grads])
        wd = float(self.recipe["weight_decay"])
        if wd:
            g = g + (wd / W) * counts.sum() * w
        g = g / counts.sum().clamp(min=1)
        client_loss = (losses.detach() * mask).sum(1) / counts.clamp(min=1)
        return g, client_loss

    def server_phase(self, w, g, lr: float) -> torch.Tensor:
        """The server rule and the weight update; returns the new
        weights."""
        rho = float(self.recipe["virtual_momentum"])
        if self.sketch is None:
            self.velocity = g + rho * self.velocity
            return w - lr * self.velocity
        cs = self.sketch
        self.velocity = cs.sketch(g) + rho * self.velocity
        self.error = self.error + self.velocity
        u = topk(cs.query(self.error), int(self.recipe["k"]))
        nz = cs.sketch(u) != 0
        self.error = torch.where(nz, 0.0, self.error)
        self.velocity = torch.where(nz, 0.0, self.velocity)
        return w - lr * u


def run(rnd: Round, w0: torch.Tensor, batches: List[dict], lr: float,
        drop_clients: int = 0) -> dict:
    """The rounds of ``batches`` from weights ``w0``: each round's
    per-client losses, the first gradient as the server state holds it
    after one round (``velocity``), the per-leaf norms of the first
    dense gradient, and the weights after the last round."""
    w = w0.clone()
    losses, first = [], None
    for i, batch in enumerate(batches):
        g, client_loss = rnd.client_phase(w, batch, drop_clients)
        losses.append(client_loss.cpu().numpy())
        w = rnd.server_phase(w, g, lr)
        if i == 0:
            first = {"velocity": rnd.velocity.detach().cpu(),
                     "grad_leaf_norms": rnd.layout.leaf_norms(g)}
        del g
    return {"losses": np.stack(losses), "velocity": first["velocity"],
            "grad_leaf_norms": first["grad_leaf_norms"],
            "weights": w.detach().cpu()}
