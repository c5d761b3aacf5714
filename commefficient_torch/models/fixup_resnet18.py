"""ResNet18 and FixupResNet18, the CIFAR-scale ResNets: the port of
``commefficient_tpu/models/fixup_resnet18.py``.

A 3x3 prep conv, four stages of blocks with strides 1, 2, 2, 2 and
channels 64/128/256/256, and the head ``concat(global avg pool, global
max pool)`` (in that order) -> ``classifier``. ResNet18's block is
conv-BN-relu twice plus the shortcut (flax's ``nn.BatchNorm(name="bn1")``:
leaves ``<block>/bn1/{scale,bias}``, statistics ``<block>/bn1/{mean,var}``
as the model state); its convs and classifier draw from PyTorch's default
init (``torch_conv_init``). FixupResNet18's block has ``ScalarAdd`` /
``ScalarMul`` submodules (``add1a``, ``add1b``, ``add2a``, ``add2b``,
``mul``), ``fixup_init(L)`` first convs, zero second convs and a zero
classifier. NCHW inside, NHWC at the boundary.
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
    ScalarAdd,
    ScalarMul,
    fixup_init,
    global_avg_pool,
    global_max_pool,
    torch_conv_init,
)

__all__ = ["ResNet18", "FixupResNet18"]

_STAGES = ((64, 1), (128, 2), (256, 2), (256, 2))


class FixupBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 num_layers: float = 8.0, path=()):
        super().__init__()
        p = tuple(path)
        self.shortcut = None
        if stride != 1 or c_in != c_out:
            self.shortcut = Conv(c_in, c_out, 1, stride, 0,
                                 path=p + ("shortcut",),
                                 init=fixup_init(1.0))
        self.add1a = ScalarAdd(p + ("add1a",))
        self.conv1 = Conv(c_in, c_out, 3, stride, 1, path=p + ("conv1",),
                          init=fixup_init(num_layers))
        self.add1b = ScalarAdd(p + ("add1b",))
        self.add2a = ScalarAdd(p + ("add2a",))
        self.conv2 = Conv(c_out, c_out, 3, 1, 1, path=p + ("conv2",),
                          init="zeros")
        self.mul = ScalarMul(p + ("mul",))
        self.add2b = ScalarAdd(p + ("add2b",))

    def forward(self, x):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(self.add1b(self.conv1(self.add1a(x))))
        out = self.add2b(self.mul(self.conv2(self.add2a(out))))
        return F.relu(out + shortcut)


class PostActBlock(nn.Module):
    """conv-BN-relu x 2 + shortcut."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, path=()):
        super().__init__()
        p = tuple(path)
        self.shortcut = None
        if stride != 1 or c_in != c_out:
            self.shortcut = Conv(c_in, c_out, 1, stride, 0,
                                 path=p + ("shortcut",),
                                 init=torch_conv_init)
        self.conv1 = Conv(c_in, c_out, 3, stride, 1, path=p + ("conv1",),
                          init=torch_conv_init)
        self.bn1 = BatchNorm(c_out, p, name="bn1")
        self.conv2 = Conv(c_out, c_out, 3, 1, 1, path=p + ("conv2",),
                          init=torch_conv_init)
        self.bn2 = BatchNorm(c_out, p, name="bn2")

    def forward(self, x, ctx: BNContext):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(self.bn1(self.conv1(x), ctx))
        out = F.relu(self.bn2(self.conv2(out), ctx))
        return out + shortcut


def _head(x, classifier):
    return classifier(torch.cat([global_avg_pool(x), global_max_pool(x)],
                                dim=-1))


class ResNet18(FlaxPathed):
    do_batchnorm = True

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, initial_channels: int = 3):
        super().__init__()
        self.prep = Conv(initial_channels, 64, 3, 1, 1, path=("prep",),
                         init=torch_conv_init)
        blocks, c = [], 64
        for s, (c_out, stride) in enumerate(_STAGES):
            for b in range(num_blocks[s]):
                blocks.append(PostActBlock(c, c_out, stride if b == 0 else 1,
                                           path=(f"stage{s}_block{b}",)))
                c = c_out
        self.blocks = nn.ModuleList(blocks)
        self.classifier = Dense(2 * c, num_classes, path=("classifier",),
                                init=torch_conv_init)

    def forward(self, x_nhwc: torch.Tensor, model_state=None,
                train: bool = False):
        ctx = BNContext(model_state, train)
        out = F.relu(self.prep(x_nhwc.permute(0, 3, 1, 2)))
        for blk in self.blocks:
            out = blk(out, ctx)
        return self._wrap_out(_head(out, self.classifier), ctx, model_state,
                              train)


class FixupResNet18(FlaxPathed):
    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, initial_channels: int = 3):
        super().__init__()
        num_layers = float(sum(num_blocks))
        self.prep = Conv(initial_channels, 64, 3, 1, 1, path=("prep",),
                         init=fixup_init(1.0))
        blocks, c = [], 64
        for s, (c_out, stride) in enumerate(_STAGES):
            for b in range(num_blocks[s]):
                blocks.append(FixupBlock(c, c_out, stride if b == 0 else 1,
                                         num_layers,
                                         path=(f"stage{s}_block{b}",)))
                c = c_out
        self.blocks = nn.ModuleList(blocks)
        self.classifier = Dense(2 * c, num_classes, path=("classifier",),
                                init="zeros")

    def forward(self, x_nhwc: torch.Tensor, model_state=None,
                train: bool = False):
        out = F.relu(self.prep(x_nhwc.permute(0, 3, 1, 2)))
        for blk in self.blocks:
            out = blk(out)
        return _head(out, self.classifier)
