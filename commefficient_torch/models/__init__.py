"""Model zoo of the port. This slice carries ResNet9; the other CV models
and GPT-2 are later slices (ROADMAP.md, queue 1)."""

from commefficient_torch.models.resnet9 import ResNet9

__all__ = ["ResNet9"]
