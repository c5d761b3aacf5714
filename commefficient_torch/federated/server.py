"""Server-side update rules: the port of
``commefficient_tpu/federated/server.py`` (the unsharded server), the five
compression modes with error feedback and virtual momentum.

``server_update`` takes the data-weighted round gradient (a dense ``(d,)``
vector, or the ``(r, c_pad)`` table in sketch mode) and the server's
``(velocity, error)`` state and returns the weight update (times the
learning rate) and the new state:

- ``fedavg``: the averaged weight delta plus virtual momentum (the lr was
  applied on the clients; the round passes lr = 1);
- ``uncompressed``: the momentum-accumulated gradient, with server DP noise
  under ``dp_mode == "server"`` (drawn from an explicit
  ``torch.Generator``);
- ``true_topk``: the top-k of the virtual error, error and velocity zeroed
  where it kept a coordinate;
- ``local_topk``: the clients' already top-k'd sum plus virtual momentum;
- ``sketch`` (FetchSGD): momentum and error accumulate in table space, the
  update is the top-k of the error table's median-of-rows estimates, and
  error and velocity are zeroed at the nonzero cells of the update's
  re-sketch. With ``fused_epilogue`` (``--fused_epilogue``) and the chunk
  layout, the mask, the update and its re-sketch come from one epilogue
  sweep over the estimates (``ops/sketch.fused_epilogue_chunks``),
  bit-identical to the composed pair.

The legality asserts of ``ServerConfig`` are the JAX package's, verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from commefficient_torch.ops.flat import ChunkLayout
from commefficient_torch.ops.sketch import (
    CountSketch,
    estimates_chunks,
    fused_epilogue_chunks,
    sketch_chunks,
    unsketch_chunks,
)
from commefficient_torch.ops.topk import topk

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
    do_dp: bool = False
    dp_mode: str = "worker"
    noise_multiplier: float = 0.0
    # sketch mode, chunked layout: one epilogue sweep for the threshold
    # mask, the update and its re-sketch
    fused_epilogue: bool = False

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
    """(velocity, error): ``(num_rows, c_pad)`` tables in sketch mode,
    else ``(grad_size,)`` vectors."""

    velocity: torch.Tensor
    error: torch.Tensor


def init_server_state(cfg: ServerConfig,
                      sketch: Optional[CountSketch] = None,
                      device=None) -> ServerState:
    """Zero state on ``device`` (the sketch's device in sketch mode, else
    ``device``, default ``cuda``)."""
    if cfg.mode == "sketch":
        assert sketch is not None
        shape, device = sketch.table_shape, sketch.device
    else:
        shape = (cfg.grad_size,)
        device = torch.device(device if device is not None else "cuda")
    return ServerState(
        velocity=torch.zeros(shape, dtype=torch.float32, device=device),
        error=torch.zeros(shape, dtype=torch.float32, device=device))


def server_update(gradient: torch.Tensor, state: ServerState,
                  cfg: ServerConfig, lr, sketch: Optional[CountSketch] = None,
                  rng: Optional[torch.Generator] = None,
                  layout: Optional[ChunkLayout] = None
                  ) -> Tuple[torch.Tensor, ServerState]:
    """One server step: the aggregated round gradient -> (update x lr, new
    state). ``layout`` (sketch mode only) selects the chunked-resident
    data plane: the update is in the ``(T, S, 128)`` chunk layout, else
    flat ``(d,)``. ``rng`` is the generator of server DP noise
    (``uncompressed`` with ``dp_mode == "server"``)."""
    helper = {
        "fedavg": _fedavg,
        "uncompressed": _uncompressed,
        "true_topk": _true_topk,
        "local_topk": _local_topk,
        "sketch": _sketched,
    }[cfg.mode]
    if cfg.mode == "sketch":
        return helper(gradient, state, cfg, lr, sketch, layout)
    assert layout is None, "chunked-resident layout is sketch-mode only"
    if cfg.mode == "uncompressed":
        return helper(gradient, state, cfg, lr, rng)
    return helper(gradient, state, cfg, lr)


def _fedavg(avg_update, state, cfg, lr):
    # lr already applied on the clients; the round passes lr = 1
    velocity = avg_update + cfg.virtual_momentum * state.velocity
    return velocity, ServerState(velocity, state.error)


def _uncompressed(gradient, state, cfg, lr, rng):
    velocity = gradient + cfg.virtual_momentum * state.velocity
    update = velocity
    if cfg.do_dp and cfg.dp_mode == "server":
        assert rng is not None, "server DP needs a generator"
        update = update + cfg.noise_multiplier * torch.randn(
            update.shape, generator=rng, dtype=update.dtype,
            device=update.device)
    return update * lr, ServerState(velocity, state.error)


def _true_topk(gradient, state, cfg, lr):
    velocity = gradient + cfg.virtual_momentum * state.velocity
    error = state.error + velocity
    update = topk(error, cfg.k)
    nz = update != 0
    # error feedback and momentum factor masking at the chosen coordinates
    zero = torch.zeros((), dtype=error.dtype, device=error.device)
    error = torch.where(nz, zero, error)
    velocity = torch.where(nz, zero, velocity)
    return update * lr, ServerState(velocity, error)


def _local_topk(local_topk_grad, state, cfg, lr):
    # no virtual error and no masking: the clients top-k'd their transmits
    velocity = local_topk_grad + cfg.virtual_momentum * state.velocity
    return velocity * lr, ServerState(velocity, state.error)


def _sketched(sketched_grad, state, cfg, lr, sketch: CountSketch,
              layout: Optional[ChunkLayout] = None):
    velocity = sketched_grad + cfg.virtual_momentum * state.velocity
    if cfg.error_type == "virtual":
        error = state.error + velocity
    else:  # "local", and "none": unsketch the velocity (JAX deviation note)
        error = velocity
    if layout is not None and cfg.fused_epilogue:
        upd3, sketched_update = fused_epilogue_chunks(
            sketch, estimates_chunks(sketch, error), cfg.k)
    else:
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
