"""ResNet9 (cifar10-fast topology): the port of
``commefficient_tpu/models/resnet9.py``.

prep ConvBN -> layer1(pool) + residual -> layer2(pool) -> layer3(pool) +
residual -> maxpool(min(4, H)) -> bias-free linear -> x ``weight`` output
scale. An ``nn.Module`` computing in NCHW that takes NHWC batches at its
boundary (the JAX package's layout, which the data loader emits).

``jax_param_path`` names each parameter's flax path, which fixes the
model's flat vector in JAX ravel order (ops/flat.ParamLayout), and
``jax_param_kind`` its layout kind. Under
``--batchnorm`` each ConvBN cell carries flax's BatchNorm: its ``scale``
and ``bias`` are parameters (``<cell>/BatchNorm_0/...``, ahead of the
cell's ``Conv_0`` in ravel order), its running statistics the model state
(``initial_model_state``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from commefficient_torch.models.layers import (
    BatchNorm,
    BNContext,
    ConvBN,
    max_pool,
)

__all__ = ["ResNet9"]

DEFAULT_CHANNELS = (("prep", 64), ("layer1", 128), ("layer2", 256),
                    ("layer3", 512))


class Residual(nn.Module):
    """x + relu(ConvBN(ConvBN(x)))."""

    def __init__(self, c: int, do_batchnorm: bool = False, path=()):
        super().__init__()
        self.res1 = ConvBN(c, c, do_batchnorm=do_batchnorm,
                           path=tuple(path) + ("res1",))
        self.res2 = ConvBN(c, c, do_batchnorm=do_batchnorm,
                           path=tuple(path) + ("res2",))

    def forward(self, x, ctx: BNContext = None):
        return x + torch.relu(self.res2(self.res1(x, ctx), ctx))


class ResNet9(nn.Module):
    def __init__(self, channels: Tuple[Tuple[str, int], ...] = DEFAULT_CHANNELS,
                 weight: float = 0.125, pool: int = 2, num_classes: int = 10,
                 initial_channels: int = 3,
                 new_num_classes: Optional[int] = None,
                 do_batchnorm: bool = False):
        super().__init__()
        ch = dict(channels)
        bn = bool(do_batchnorm)
        self.do_batchnorm = bn
        self.weight = weight
        self.prep = ConvBN(initial_channels, ch["prep"], do_batchnorm=bn,
                           path=("prep",))
        self.layer1 = ConvBN(ch["prep"], ch["layer1"], pool=pool,
                             do_batchnorm=bn, path=("layer1",))
        self.res1 = Residual(ch["layer1"], bn, path=("res1",))
        self.layer2 = ConvBN(ch["layer1"], ch["layer2"], pool=pool,
                             do_batchnorm=bn, path=("layer2",))
        self.layer3 = ConvBN(ch["layer2"], ch["layer3"], pool=pool,
                             do_batchnorm=bn, path=("layer3",))
        self.res3 = Residual(ch["layer3"], bn, path=("res3",))
        self.linear = nn.Linear(ch["layer3"], new_num_classes or num_classes,
                                bias=False)

    def initial_model_state(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics at init (flax's: mean 0, var
        1), keyed ``"<flax path>/BatchNorm_0/{mean,var}"``; empty without
        ``--batchnorm``."""
        state = {}
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                state.update(mod.initial_state())
        return dict(sorted(state.items()))

    def forward(self, x_nhwc: torch.Tensor, model_state=None,
                train: bool = False):
        """Logits of NHWC images. With ``--batchnorm`` the call takes the
        running statistics and returns ``(logits, new_model_state)``: in
        train mode the updated running statistics, in eval mode
        ``model_state`` itself."""
        ctx = BNContext(model_state, train) if self.do_batchnorm else None
        out = self.prep(x_nhwc.permute(0, 3, 1, 2), ctx)
        out = self.res1(self.layer1(out, ctx), ctx)
        out = self.layer3(self.layer2(out, ctx), ctx)
        out = self.res3(out, ctx)
        out = max_pool(out, min(4, out.shape[2]))
        # the stems of 32x32 and 28x28 inputs both end at 1x1 here, so the
        # NCHW flatten equals the flax NHWC flatten
        out = out.reshape(out.shape[0], -1)
        logits = self.linear(out) * self.weight
        if ctx is None:
            return logits
        return logits, (dict(sorted(ctx.new.items())) if train
                        else model_state)

    @staticmethod
    def finetune_trainable(path: Tuple[str, ...]) -> bool:
        """Head-only finetuning: True for the leaves of the ``linear``
        head (``path`` a flax path, as ``jax_param_path`` gives it)."""
        return "linear" in path

    @staticmethod
    def jax_param_path(torch_name: str) -> Tuple[str, ...]:
        """``"res1.res2.conv.weight"`` -> ``("res1", "res2", "Conv_0",
        "kernel")``; ``"prep.bn.scale"`` -> ``("prep", "BatchNorm_0",
        "scale")``; ``"linear.weight"`` -> ``("linear", "kernel")``."""
        parts = torch_name.split(".")
        if parts[-2:] == ["conv", "weight"]:
            return tuple(parts[:-2]) + ("Conv_0", "kernel")
        if parts[-2:] in (["bn", "scale"], ["bn", "bias"]):
            return tuple(parts[:-2]) + ("BatchNorm_0", parts[-1])
        if parts == ["linear", "weight"]:
            return ("linear", "kernel")
        raise KeyError(f"no flax path for parameter {torch_name!r}")

    @staticmethod
    def jax_param_kind(torch_name: str) -> str:
        """The leaf's layout kind (``ops/flat.LEAF_KINDS``): the conv
        kernels ``conv``, the linear kernel ``dense``, the BatchNorm
        ``scale``/``bias`` ``asis``."""
        if torch_name.endswith("conv.weight"):
            return "conv"
        if torch_name == "linear.weight":
            return "dense"
        return "asis"
