"""ResNet9 (cifar10-fast topology): the port of
``commefficient_tpu/models/resnet9.py``.

prep ConvBN -> layer1(pool) + residual -> layer2(pool) -> layer3(pool) +
residual -> maxpool(min(4, H)) -> bias-free linear -> x ``weight`` output
scale. An ``nn.Module`` computing in NCHW that takes NHWC batches at its
boundary (the JAX package's layout, which the data loader emits).

``jax_param_path`` names each parameter's flax path, which fixes the
model's flat vector in JAX ravel order (ops/flat.ParamLayout).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from commefficient_torch.models.layers import ConvBN, max_pool

__all__ = ["ResNet9"]

DEFAULT_CHANNELS = (("prep", 64), ("layer1", 128), ("layer2", 256),
                    ("layer3", 512))


class Residual(nn.Module):
    """x + relu(ConvBN(ConvBN(x)))."""

    def __init__(self, c: int):
        super().__init__()
        self.res1 = ConvBN(c, c)
        self.res2 = ConvBN(c, c)

    def forward(self, x):
        return x + torch.relu(self.res2(self.res1(x)))


class ResNet9(nn.Module):
    def __init__(self, channels: Tuple[Tuple[str, int], ...] = DEFAULT_CHANNELS,
                 weight: float = 0.125, pool: int = 2, num_classes: int = 10,
                 initial_channels: int = 3,
                 new_num_classes: Optional[int] = None):
        super().__init__()
        ch = dict(channels)
        self.weight = weight
        self.prep = ConvBN(initial_channels, ch["prep"])
        self.layer1 = ConvBN(ch["prep"], ch["layer1"], pool=pool)
        self.res1 = Residual(ch["layer1"])
        self.layer2 = ConvBN(ch["layer1"], ch["layer2"], pool=pool)
        self.layer3 = ConvBN(ch["layer2"], ch["layer3"], pool=pool)
        self.res3 = Residual(ch["layer3"])
        self.linear = nn.Linear(ch["layer3"], new_num_classes or num_classes,
                                bias=False)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        out = self.prep(x_nhwc.permute(0, 3, 1, 2))
        out = self.res1(self.layer1(out))
        out = self.layer3(self.layer2(out))
        out = self.res3(out)
        out = max_pool(out, min(4, out.shape[2]))
        # the stems of 32x32 and 28x28 inputs both end at 1x1 here, so the
        # NCHW flatten equals the flax NHWC flatten
        out = out.reshape(out.shape[0], -1)
        return self.linear(out) * self.weight

    @staticmethod
    def jax_param_path(torch_name: str) -> Tuple[str, ...]:
        """``"res1.res2.conv.weight"`` -> ``("res1", "res2", "Conv_0",
        "kernel")``; ``"linear.weight"`` -> ``("linear", "kernel")``."""
        parts = torch_name.split(".")
        if parts[-2:] == ["conv", "weight"]:
            return tuple(parts[:-2]) + ("Conv_0", "kernel")
        if parts == ["linear", "weight"]:
            return ("linear", "kernel")
        raise KeyError(f"no flax path for parameter {torch_name!r}")
