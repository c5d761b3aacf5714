"""Client-side configuration and helpers: the port of
``commefficient_tpu/federated/worker.py`` for the fused sketch-mode round.

Semantics preserved: the round transmits the data-weighted sum of
per-client gradients (per-example-mean gradient x local batch size), with
weight decay folded in as ``wd / num_workers x weights`` per datum. The
per-client worker path (local momentum/error, clipping, DP, local top-k,
fedavg) is a later slice (ROADMAP.md, queue 1); this slice runs the
fused-gradient client phase of ``federated/rounds.py``, composed or
streamed (``sketch_grad_tree``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from commefficient_torch.ops.flat import LeafSegment, SegmentGroup
from commefficient_torch.ops.sketch import (
    CountSketch,
    sketch_segment_accum,
    sketch_segments_accum,
)


@dataclass(frozen=True)
class WorkerConfig:
    mode: str
    error_type: str = "none"
    k: int = 0
    num_workers: int = 1
    weight_decay: float = 0.0
    local_momentum: float = 0.0
    microbatch_size: int = -1
    max_grad_norm: Optional[float] = None

    @property
    def has_velocity(self) -> bool:
        # client velocities exist iff local_momentum > 0
        return self.local_momentum > 0

    @property
    def has_error(self) -> bool:
        # client errors exist iff error_type == "local"
        return self.error_type == "local"


def microbatch_plan(B: int, microbatch_size: int):
    """``(mb, n_iters, pad)`` for splitting a B-example batch into equal
    microbatch slices (<= 0 means whole-batch)."""
    mb = B if microbatch_size <= 0 else min(microbatch_size, B)
    n_iters = -(-B // mb)
    return mb, n_iters, n_iters * mb - B


def split_microbatches(batch: Dict[str, torch.Tensor], mb: int, n_iters: int,
                       pad: int, example_dim: int = 0):
    """Reshape every batch leaf's example axis into ``(n_iters, mb)``
    zero-padded microbatch slices, with the microbatch axis moved to the
    front."""
    def split(x):
        if pad:
            shape = list(x.shape)
            shape[example_dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim=example_dim)
        x = x.reshape(x.shape[:example_dim] + (n_iters, mb)
                      + x.shape[example_dim + 1:])
        return torch.movedim(x, example_dim, 0)

    return {k: split(v) for k, v in batch.items()}


def forward_metrics(compute_loss, params, model_state, batch):
    """The val path of ``forward_grad``: ``(loss_mean, *metric_means,
    count)`` over the masked batch, without a gradient."""
    with torch.no_grad():
        loss_sum, msums, count, _ = compute_loss(params, model_state, batch,
                                                 None, False)
    denom = torch.clamp(count, min=1.0)
    return (loss_sum / denom,) + tuple(m / denom for m in msums) + (count,)


def sketch_grad_tree(sketch: CountSketch, table: torch.Tensor,
                     grads: Sequence[torch.Tensor],
                     segments: Sequence[LeafSegment],
                     groups: Optional[Sequence[SegmentGroup]] = None
                     ) -> torch.Tensor:
    """Stream leaf gradients into a running count-sketch table (the JAX
    package's ``sketch_grad_tree``): each leaf is accumulated at its flat
    offset (``ops/flat.leaf_segments``), so the d-vector is never formed.
    ``grads`` come in offset order (the JAX layout of each leaf), so per
    table cell the adds continue the composed path's chunk-ordered fold.
    With ``groups`` (an ``ops/flat.coalesce_segments`` plan) each group of
    adjacent leaves is one accumulate launch; without, one per leaf."""
    assert len(grads) == len(segments), (len(grads), len(segments))
    for g, seg in zip(grads, segments):
        assert g.numel() == seg.size, (tuple(g.shape), seg)
    if groups is None:
        for g, seg in zip(grads, segments):
            table = sketch_segment_accum(sketch, table, g, seg.offset)
        return table
    assert groups[0].start == 0 and groups[-1].stop == len(segments) \
        and all(a.stop == b.start for a, b in zip(groups[:-1], groups[1:])), \
        "groups must partition the leaf segments in order"
    for grp in groups:
        table = sketch_segments_accum(sketch, table,
                                      grads[grp.start:grp.stop], grp.offset)
    return table
