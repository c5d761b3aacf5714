"""Server-side update rule: the port of ``commefficient_tpu/federated/server.py``
for sketch mode.

``server_update`` takes the data-weighted round table and the server's
``(velocity, error)`` tables and returns the dense weight update (times the
learning rate) and the new state. In sketch mode with virtual error
(FetchSGD): momentum and error accumulate in table space, the update is
the top-k of the error table's median-of-rows estimates, and error and
velocity are zeroed at the nonzero cells of the update's re-sketch.

The legality asserts of ``ServerConfig`` are the JAX package's, verbatim.
The other four modes are later slices (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from commefficient_torch.ops.flat import ChunkLayout
from commefficient_torch.ops.sketch import (
    CountSketch,
    sketch_chunks,
    unsketch_chunks,
)

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed")
ERROR_TYPES = ("none", "local", "virtual")


@dataclass(frozen=True)
class ServerConfig:
    """Static server config."""

    mode: str
    error_type: str = "none"
    k: int = 0
    grad_size: int = 0
    virtual_momentum: float = 0.0
    local_momentum: float = 0.0

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.error_type in ERROR_TYPES, self.error_type
        if self.mode == "fedavg":
            assert self.error_type == "none", "fedavg requires error_type=none"
            assert self.local_momentum == 0, "fedavg requires local_momentum=0"
        if self.mode == "true_topk":
            assert self.error_type == "virtual", "true_topk requires virtual error"
        if self.mode == "local_topk":
            assert self.error_type in ("local", "none")
        if self.mode == "sketch":
            if self.error_type == "local":
                assert self.virtual_momentum == 0, \
                    "sketch + local error carries momentum locally: set " \
                    "--virtual_momentum 0"
            if self.error_type == "virtual":
                assert self.local_momentum == 0, \
                    "sketch + virtual error carries momentum on the " \
                    "server: set --local_momentum 0 (the CLI default 0.9 " \
                    "mirrors the reference and must be overridden for " \
                    "the FetchSGD recipe)"


class ServerState(NamedTuple):
    """(velocity, error): ``(num_rows, c_pad)`` tables in sketch mode."""

    velocity: torch.Tensor
    error: torch.Tensor


def init_server_state(cfg: ServerConfig,
                      sketch: Optional[CountSketch] = None) -> ServerState:
    if cfg.mode != "sketch":
        raise NotImplementedError(
            f"server mode {cfg.mode!r} is not ported yet (ROADMAP.md, queue "
            "1: the other server modes)")
    assert sketch is not None
    shape = sketch.table_shape
    return ServerState(
        velocity=torch.zeros(shape, dtype=torch.float32, device=sketch.device),
        error=torch.zeros(shape, dtype=torch.float32, device=sketch.device))


def server_update(gradient: torch.Tensor, state: ServerState,
                  cfg: ServerConfig, lr, sketch: Optional[CountSketch] = None,
                  layout: Optional[ChunkLayout] = None
                  ) -> Tuple[torch.Tensor, ServerState]:
    """One server step: the aggregated round table -> (update x lr, new
    state). With ``layout`` (the chunked-resident data plane) the update is
    in the ``(T, S, 128)`` chunk layout, else flat ``(d,)``."""
    if cfg.mode != "sketch":
        raise NotImplementedError(
            f"server mode {cfg.mode!r} is not ported yet (ROADMAP.md, queue "
            "1: the other server modes)")
    return _sketched(gradient, state, cfg, lr, sketch, layout)


def _sketched(sketched_grad, state, cfg, lr, sketch: CountSketch,
              layout: Optional[ChunkLayout] = None):
    velocity = sketched_grad + cfg.virtual_momentum * state.velocity
    if cfg.error_type == "virtual":
        error = state.error + velocity
    else:  # "local", and "none": unsketch the velocity (JAX deviation note)
        error = velocity
    upd3 = unsketch_chunks(sketch, error, cfg.k)
    sketched_update = sketch_chunks(sketch, upd3)
    update = upd3 if layout is not None else sketch.chunk_layout.unchunk(upd3)
    cell_nz = sketched_update != 0
    zero = torch.zeros((), dtype=error.dtype, device=error.device)
    if cfg.error_type == "virtual":
        error = torch.where(cell_nz, zero, error)
    velocity = torch.where(cell_nz, zero, velocity)
    if cfg.error_type == "local":
        # the reference aliases Verror and Vvelocity after masking
        error = velocity
    return update * lr, ServerState(velocity, error)
