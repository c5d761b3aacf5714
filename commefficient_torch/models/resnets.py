"""Deep ResNet family with batch or layer norm: the port of
``commefficient_tpu/models/resnets.py`` (the reference's torchvision fork,
with a LayerNorm option and a configurable stem).

``BasicBlock`` and ``Bottleneck`` (groups and ``width_per_group`` for the
ResNeXt and wide variants), ``_Norm`` (``batch`` | ``layer``) and the
factory functions ``resnet18`` ... ``wide_resnet101_2``. NCHW inside, NHWC
at the boundary. Every leaf names its flax path, which fixes the flat
vector in JAX ravel order: ``_Norm(name="bn1")`` wraps an auto-named
module, so a block's norm leaves are ``layer1_0/bn1/LayerNorm2d_0/
LayerNorm_0/{scale,bias}`` or ``layer1_0/bn1/BatchNorm_0/{scale,bias}``.
Convolutions draw from ``kaiming_normal_fan_out``, the ``fc`` kernel from
flax's default ``lecun_normal``.

``initial_channels`` sets the stem's input channels (flax infers them
from the batch; the default 1 is the fork's EMNIST stem). Under
``norm="batch"`` the running statistics are the model state
(``initial_model_state``; ``forward`` returns ``(logits, new_state)``),
keyed ``"<flax path>/BatchNorm_0/{mean,var}"`` as flax's ``batch_stats``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from commefficient_torch.models.layers import (
    BatchNorm,
    BNContext,
    Conv,
    Dense,
    FlaxPathed,
    LayerNorm2d,
    global_avg_pool,
)

__all__ = [
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "resnext50_32x4d",
    "resnext101_32x8d",
    "wide_resnet50_2",
    "wide_resnet101_2",
]


class _Norm(nn.Module):
    """flax's ``_Norm(kind, name=...)``: BatchNorm (momentum 0.9, epsilon
    1e-5) or ``LayerNorm2d`` under the module path ``path``."""

    def __init__(self, kind: str, c: int, path):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.norm = BatchNorm(c, path)
        elif kind == "layer":
            self.norm = LayerNorm2d(c, tuple(path) + ("LayerNorm2d_0",))
        else:
            raise ValueError(f"norm {kind!r}: expected 'batch' or 'layer'")

    def forward(self, x, ctx: BNContext = None):
        if self.kind == "batch":
            return self.norm(x, ctx)
        return self.norm(x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 norm: str = "batch", path=()):
        super().__init__()
        p = tuple(path)
        self.conv1 = Conv(c_in, planes, 3, stride, 1, path=p + ("conv1",))
        self.bn1 = _Norm(norm, planes, p + ("bn1",))
        self.conv2 = Conv(planes, planes, 3, 1, 1, path=p + ("conv2",))
        self.bn2 = _Norm(norm, planes, p + ("bn2",))
        self.down = None
        if stride != 1 or c_in != planes:
            self.down = Conv(c_in, planes, 1, stride, 0,
                             path=p + ("down_conv",))
            self.down_norm = _Norm(norm, planes, p + ("down_norm",))

    def forward(self, x, ctx=None):
        out = F.relu(self.bn1(self.conv1(x), ctx))
        out = self.bn2(self.conv2(out), ctx)
        identity = x
        if self.down is not None:
            identity = self.down_norm(self.down(x), ctx)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 norm: str = "batch", groups: int = 1, base_width: int = 64,
                 path=()):
        super().__init__()
        p = tuple(path)
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = Conv(c_in, width, 1, path=p + ("conv1",))
        self.bn1 = _Norm(norm, width, p + ("bn1",))
        self.conv2 = Conv(width, width, 3, stride, 1, groups=groups,
                          path=p + ("conv2",))
        self.bn2 = _Norm(norm, width, p + ("bn2",))
        self.conv3 = Conv(width, out_ch, 1, path=p + ("conv3",))
        self.bn3 = _Norm(norm, out_ch, p + ("bn3",))
        self.down = None
        if stride != 1 or c_in != out_ch:
            self.down = Conv(c_in, out_ch, 1, stride, 0,
                             path=p + ("down_conv",))
            self.down_norm = _Norm(norm, out_ch, p + ("down_norm",))

    def forward(self, x, ctx=None):
        out = F.relu(self.bn1(self.conv1(x), ctx))
        out = F.relu(self.bn2(self.conv2(out), ctx))
        out = self.bn3(self.conv3(out), ctx)
        identity = x
        if self.down is not None:
            identity = self.down_norm(self.down(x), ctx)
        return F.relu(out + identity)


class ResNet(FlaxPathed):
    def __init__(self, block: str = "bottleneck",
                 layers: Sequence[int] = (3, 4, 23, 3),
                 num_classes: int = 1000, norm: str = "batch",
                 groups: int = 1, width_per_group: int = 64,
                 initial_channels: int = 1):
        super().__init__()
        self.do_batchnorm = norm == "batch"
        self.conv1 = Conv(initial_channels, 64, 7, 2, 3, path=("conv1",))
        self.bn1 = _Norm(norm, 64, ("bn1",))
        blocks = []
        c = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                layers)):
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                path = (f"layer{stage + 1}_{b}",)
                if block == "basic":
                    blk = BasicBlock(c, planes, stride, norm, path=path)
                    c = planes * BasicBlock.expansion
                else:
                    blk = Bottleneck(c, planes, stride, norm, groups,
                                     width_per_group, path=path)
                    c = planes * Bottleneck.expansion
                blocks.append(blk)
        self.blocks = nn.ModuleList(blocks)
        self.fc = Dense(c, num_classes, path=("fc",))

    def forward(self, x_nhwc: torch.Tensor, model_state=None,
                train: bool = False):
        ctx = BNContext(model_state, train) if self.do_batchnorm else None
        out = F.relu(self.bn1(self.conv1(x_nhwc.permute(0, 3, 1, 2)), ctx))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        for blk in self.blocks:
            out = blk(out, ctx)
        logits = self.fc(global_avg_pool(out))
        return self._wrap_out(logits, ctx, model_state, train)


def resnet18(**kw):
    return ResNet(block="basic", layers=(2, 2, 2, 2), **kw)


def resnet34(**kw):
    return ResNet(block="basic", layers=(3, 4, 6, 3), **kw)


def resnet50(**kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), **kw)


def resnet152(**kw):
    return ResNet(block="bottleneck", layers=(3, 8, 36, 3), **kw)


def resnext50_32x4d(**kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), groups=32,
                  width_per_group=4, **kw)


def resnext101_32x8d(**kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), groups=32,
                  width_per_group=8, **kw)


def wide_resnet50_2(**kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3),
                  width_per_group=128, **kw)


def wide_resnet101_2(**kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3),
                  width_per_group=128, **kw)
