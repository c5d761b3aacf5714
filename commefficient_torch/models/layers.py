"""Shared layers: the port of ``commefficient_tpu/models/layers.py`` for the
ResNet9 slice.

Modules compute in PyTorch's NCHW layout. Init is PyTorch's own default for
``nn.Conv2d``/``nn.Linear`` (kaiming_uniform(a=sqrt(5)), i.e.
Uniform(+-1/sqrt(fan_in))), which is the distribution the JAX package's
``torch_conv_init`` reproduces; weights carried across from the JAX package
come in through ``commefficient_torch/convert.py``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


@torch.no_grad()
def torch_conv_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv/linear weight from PyTorch's default
    Uniform(+-1/sqrt(fan_in)) with an explicit generator (the module
    constructors draw from the global one)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            bound = 1.0 / fan_in ** 0.5
            w.copy_(torch.empty(w.shape, dtype=w.dtype).uniform_(
                -bound, bound, generator=generator))


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping max-pool (VALID: a ragged edge is dropped, as in
    flax's ``nn.max_pool`` with strides equal to the window)."""
    return F.max_pool2d(x, window, stride=window)


class ConvBN(nn.Module):
    """3x3 conv without bias + ReLU + optional max-pool (the reference's
    ``ConvBN`` cell with BatchNorm off). BatchNorm is not ported in this
    slice (ROADMAP.md, queue 1)."""

    def __init__(self, c_in: int, c_out: int, pool: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.pool = pool

    def forward(self, x):
        x = F.relu(self.conv(x))
        if self.pool:
            x = max_pool(x, self.pool)
        return x
