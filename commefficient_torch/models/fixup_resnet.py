"""FixupResNet50, the normalization-free ImageNet ResNet: the port of
``commefficient_tpu/models/fixup_resnet.py``.

Bottleneck blocks with ``ScalarAdd`` biases around each of the three
convs and a ``ScalarMul`` after the last; conv1 and conv2 draw from
``variance_scaling(2 / sqrt(L), fan_out, normal)`` (Fixup's L^(-1/4) a
conv for m = 3), conv3 and the ``fc`` head are zeros. The projection
shortcut is flax's ``avg_pool((1, 1), stride)``, a strided subsample,
then ``ScalarAdd`` (``bias_sc``), then a 1x1 conv. NCHW inside, NHWC at
the boundary.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from commefficient_torch.models.layers import (
    Conv,
    Dense,
    FlaxPathed,
    ScalarAdd,
    ScalarMul,
    fixup_init,
    global_avg_pool,
)

__all__ = ["FixupResNet50"]


class FixupBottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 num_layers: float = 16.0, path=()):
        super().__init__()
        p = tuple(path)
        scaled = ("normal_fan_out", 2.0 / (num_layers ** 0.5))
        out_ch = planes * self.expansion
        self.stride = stride
        self.shortcut = None
        if stride != 1 or c_in != out_ch:
            self.bias_sc = ScalarAdd(p + ("bias_sc",))
            self.shortcut = Conv(c_in, out_ch, 1, path=p + ("shortcut",),
                                 init=fixup_init(1.0))
        self.bias1a = ScalarAdd(p + ("bias1a",))
        self.conv1 = Conv(c_in, planes, 1, path=p + ("conv1",), init=scaled)
        self.bias1b = ScalarAdd(p + ("bias1b",))
        self.bias2a = ScalarAdd(p + ("bias2a",))
        self.conv2 = Conv(planes, planes, 3, stride, 1, path=p + ("conv2",),
                          init=scaled)
        self.bias2b = ScalarAdd(p + ("bias2b",))
        self.bias3a = ScalarAdd(p + ("bias3a",))
        self.conv3 = Conv(planes, out_ch, 1, path=p + ("conv3",),
                          init="zeros")
        self.scale = ScalarMul(p + ("scale",))
        self.bias3b = ScalarAdd(p + ("bias3b",))

    def forward(self, x):
        shortcut = x
        if self.shortcut is not None:
            s = self.stride
            shortcut = self.shortcut(self.bias_sc(x[:, :, ::s, ::s]))
        out = F.relu(self.bias1b(self.conv1(self.bias1a(x))))
        out = F.relu(self.bias2b(self.conv2(self.bias2a(out))))
        out = self.bias3b(self.scale(self.conv3(self.bias3a(out))))
        return F.relu(out + shortcut)


class FixupResNet50(FlaxPathed):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, initial_channels: int = 3):
        super().__init__()
        num_layers = float(sum(layers))
        self.conv1 = Conv(initial_channels, 64, 7, 2, 3, path=("conv1",),
                          init=fixup_init(1.0))
        self.bias1 = ScalarAdd(("bias1",))
        blocks, c = [], 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                layers)):
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(FixupBottleneck(
                    c, planes, stride, num_layers,
                    path=(f"layer{stage + 1}_{b}",)))
                c = planes * FixupBottleneck.expansion
        self.blocks = nn.ModuleList(blocks)
        self.bias2 = ScalarAdd(("bias2",))
        self.fc = Dense(c, num_classes, path=("fc",), init="zeros")

    def forward(self, x_nhwc: torch.Tensor, model_state=None,
                train: bool = False):
        out = F.relu(self.bias1(self.conv1(x_nhwc.permute(0, 3, 1, 2))))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        for blk in self.blocks:
            out = blk(out)
        return self.fc(self.bias2(global_avg_pool(out)))
