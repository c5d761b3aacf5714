"""The port's ResNet9 and its CV losses for a ``resnet9`` configuration."""

import torch

from commefficient_torch.federated.losses import make_cv_losses
from commefficient_torch.models import ResNet9


def build(cfg):
    ch = cfg["channels"]
    with torch.device("meta"):
        model = ResNet9(channels=tuple((k, ch[k]) for k in (
            "prep", "layer1", "layer2", "layer3")),
            weight=cfg["output_scale"], num_classes=cfg["num_classes"],
            initial_channels=cfg["image_channels"])
    train_loss, val_loss = make_cv_losses(model)
    return model, train_loss, val_loss
