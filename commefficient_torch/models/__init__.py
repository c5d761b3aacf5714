"""Model zoo of the port: ResNet9 and GPT-2 with double heads. The other
CV models are a later slice (ROADMAP.md, queue 1 item 3)."""

from commefficient_torch.models.gpt2 import GPT2DoubleHeads
from commefficient_torch.models.resnet9 import ResNet9

__all__ = ["GPT2DoubleHeads", "ResNet9"]
