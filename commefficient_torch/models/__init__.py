"""Model zoo of the port: the JAX package's registry
(``commefficient_tpu/models/__init__.py``), the same names. Each model
computes in NCHW, takes NHWC batches at its boundary and names its
leaves' flax paths and layout kinds, which fix its flat vector in JAX
ravel order."""

from commefficient_torch.models.fixup_resnet import FixupResNet50
from commefficient_torch.models.fixup_resnet9 import FixupResNet9
from commefficient_torch.models.fixup_resnet18 import FixupResNet18, ResNet18
from commefficient_torch.models.gpt2 import GPT2DoubleHeads
from commefficient_torch.models.resnet9 import ResNet9
from commefficient_torch.models.resnet101ln import ResNet101LN
from commefficient_torch.models.resnets import (
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    wide_resnet50_2,
    wide_resnet101_2,
)

__all__ = [
    "ResNet9",
    "FixupResNet9",
    "ResNet18",
    "FixupResNet18",
    "FixupResNet50",
    "ResNet101LN",
    "GPT2DoubleHeads",
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
