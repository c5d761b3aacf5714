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


BN_MOMENTUM = 0.9   # flax's: the weight of the OLD running statistic
BN_EPSILON = 1e-5


class BNContext:
    """The BatchNorm statistics one forward pass reads and writes:
    ``state`` maps ``"<flax path>/BatchNorm_0/{mean,var}"`` to the running
    statistics; in train mode each BatchNorm puts its updated running
    statistics into ``new`` under the same keys."""

    def __init__(self, state, train: bool):
        self.state = state
        self.train = bool(train)
        self.new = {}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an NCHW map, computed functionally (no buffers, nothing
    updated in place, so it runs under ``torch.func.vmap``).

    Train mode normalizes with the batch's statistics, as flax computes
    them: ``mean = E[x]``, ``var = max(0, E[x^2] - mean^2)`` (the biased
    variance, flax's fast variance), over every row of the batch, padding
    rows included; the running update is ``0.9 * old + 0.1 * batch`` for
    both (torch's ``momentum`` is the weight of the new statistic, and its
    running variance takes the unbiased one). Eval mode normalizes with
    the running statistics. ``y = (x - mean) * (rsqrt(var + eps) * scale)
    + bias``, in flax's order."""

    def __init__(self, c: int, path):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.key = "/".join(tuple(path) + ("BatchNorm_0",))

    def initial_state(self):
        c = self.scale.shape[0]
        return {self.key + "/mean": torch.zeros(c),
                self.key + "/var": torch.ones(c)}

    def forward(self, x, ctx: BNContext):
        if ctx.train:
            mean = x.mean(dim=(0, 2, 3))
            mean2 = (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            old_m = ctx.state[self.key + "/mean"]
            old_v = ctx.state[self.key + "/var"]
            ctx.new[self.key + "/mean"] = (BN_MOMENTUM * old_m
                                           + (1.0 - BN_MOMENTUM) * mean)
            ctx.new[self.key + "/var"] = (BN_MOMENTUM * old_v
                                          + (1.0 - BN_MOMENTUM) * var)
        else:
            # the float32 running statistics in the input's dtype (--bf16)
            mean = ctx.state[self.key + "/mean"].to(x.dtype)
            var = ctx.state[self.key + "/var"].to(x.dtype)
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        return y + self.bias[None, :, None, None]


class ConvBN(nn.Module):
    """3x3 conv without bias (+ BatchNorm under ``--batchnorm``) + ReLU +
    optional max-pool: the reference's ``ConvBN`` cell. ``path`` is the
    cell's flax path, which names its BatchNorm statistics."""

    def __init__(self, c_in: int, c_out: int, pool: int = 0,
                 do_batchnorm: bool = False, path=()):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.bn = BatchNorm(c_out, path) if do_batchnorm else None
        self.pool = pool

    def forward(self, x, ctx: BNContext = None):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, ctx)
        x = F.relu(x)
        if self.pool:
            x = max_pool(x, self.pool)
        return x
