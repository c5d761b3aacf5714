"""FixupResNet9, the normalization-free ResNet9 with Fixup init: the port
of ``commefficient_tpu/models/fixup_resnet9.py``.

Its scalars are direct parameters of the modules that use them
(``bias1a``, ``bias1b``, ``scale``, ...: flax leaves ``<module>/bias1a``),
not ``ScalarAdd`` submodules. First convs draw from ``fixup_init(1)``,
the blocks' first convs from ``fixup_init(2)``, the blocks' second convs
and the ``linear`` head are zeros. NCHW inside, NHWC at the boundary.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from commefficient_torch.models.layers import (
    Conv,
    Dense,
    FlaxPathed,
    fixup_init,
    max_pool,
)

__all__ = ["FixupResNet9"]

DEFAULT_CHANNELS = (("prep", 64), ("layer1", 128), ("layer2", 256),
                    ("layer3", 512))


def _scalars(mod: nn.Module, names) -> None:
    """Direct (1,) parameters: ``bias*`` zeros, ``scale`` ones."""
    for name in names:
        one = name == "scale"
        setattr(mod, name, nn.Parameter(torch.ones(1) if one
                                        else torch.zeros(1)))
        mod.flax_leaves[name] = (name, "asis", "ones" if one else "zeros")


class FixupBasicBlock(nn.Module):
    """Two 3x3 convs with Fixup scalars and an identity shortcut."""

    def __init__(self, c: int, num_layers: float = 2.0, path=()):
        super().__init__()
        self.flax_path = tuple(path)
        self.flax_leaves = {}
        _scalars(self, ("bias1a", "bias1b", "bias2a", "bias2b", "scale"))
        self.conv1 = Conv(c, c, 3, 1, 1, path=self.flax_path + ("conv1",),
                          init=fixup_init(num_layers))
        self.conv2 = Conv(c, c, 3, 1, 1, path=self.flax_path + ("conv2",),
                          init="zeros")

    def forward(self, x):
        out = F.relu(self.conv1(x + self.bias1a) + self.bias1b)
        out = self.conv2(out + self.bias2a) * self.scale + self.bias2b
        return F.relu(out + x)


class FixupLayer(nn.Module):
    """conv, bias, scale, relu, pool, then ``num_blocks``
    FixupBasicBlocks."""

    def __init__(self, c_in: int, c_out: int, num_blocks: int,
                 pool: int = 2, num_layers: float = 2.0, path=()):
        super().__init__()
        self.flax_path = tuple(path)
        self.flax_leaves = {}
        _scalars(self, ("bias1a", "bias1b", "scale"))
        self.conv = Conv(c_in, c_out, 3, 1, 1,
                         path=self.flax_path + ("conv",),
                         init=fixup_init(1.0))
        self.pool = pool
        self.blocks = nn.ModuleList(
            FixupBasicBlock(c_out, num_layers,
                            path=self.flax_path + (f"block{i}",))
            for i in range(num_blocks))

    def forward(self, x):
        out = F.relu(self.conv(x + self.bias1a) * self.scale + self.bias1b)
        if self.pool:
            out = max_pool(out, self.pool)
        for blk in self.blocks:
            out = blk(out)
        return out


class FixupResNet9(FlaxPathed):
    def __init__(self, channels: Tuple[Tuple[str, int], ...] =
                 DEFAULT_CHANNELS, pool: int = 2, num_classes: int = 10,
                 initial_channels: int = 3):
        super().__init__()
        ch = dict(channels)
        num_layers = 2.0
        self.flax_path = ()
        self.flax_leaves = {}
        _scalars(self, ("bias1a", "bias1b", "scale", "bias2"))
        self.conv1 = Conv(initial_channels, ch["prep"], 3, 1, 1,
                          path=("conv1",), init=fixup_init(1.0))
        self.layer1 = FixupLayer(ch["prep"], ch["layer1"], 1, pool,
                                 num_layers, path=("layer1",))
        self.layer2 = FixupLayer(ch["layer1"], ch["layer2"], 0, pool,
                                 num_layers, path=("layer2",))
        self.layer3 = FixupLayer(ch["layer2"], ch["layer3"], 1, pool,
                                 num_layers, path=("layer3",))
        self.linear = Dense(ch["layer3"], num_classes, path=("linear",),
                            init="zeros")

    def forward(self, x_nhwc: torch.Tensor, model_state=None,
                train: bool = False):
        x = x_nhwc.permute(0, 3, 1, 2)
        out = F.relu(self.conv1(x + self.bias1a) * self.scale + self.bias1b)
        out = self.layer3(self.layer2(self.layer1(out)))
        out = max_pool(out, min(4, out.shape[2]))
        # flatten in flax's NHWC order
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
        return self.linear(out + self.bias2)
