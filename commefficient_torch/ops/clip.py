"""L2-norm clipping (for DP and ``max_grad_norm``): the port of
``commefficient_tpu/ops/clip.py``.

Scale the record down so its L2 norm is at most ``l2_norm_clip``; records
already inside the ball are untouched. ``norm`` can be supplied: the
sketch-space caller passes the count sketch's ``l2estimate``.
"""

from __future__ import annotations

import torch


def clip_by_l2(record: torch.Tensor, l2_norm_clip, norm=None) -> torch.Tensor:
    if norm is None:
        norm = torch.linalg.vector_norm(record)
    scale = torch.where(norm <= l2_norm_clip, 1.0,
                        l2_norm_clip / torch.clamp(norm, min=1e-12))
    return record * scale
