"""ResNet101 with LayerNorm, the FEMNIST model: the port of
``commefficient_tpu/models/resnet101ln.py`` (``resnet101(norm="layer")``,
62 classes, a 1-channel stem)."""

from __future__ import annotations

from commefficient_torch.models.resnets import resnet101

__all__ = ["ResNet101LN"]


def ResNet101LN(num_classes: int = 62, initial_channels: int = 1, **kw):
    kw.pop("do_batchnorm", None)
    return resnet101(num_classes=num_classes, norm="layer",
                     initial_channels=initial_channels)
