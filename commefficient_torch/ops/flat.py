"""Flat-parameter-vector plumbing and the chunked resident layout.

``ChunkLayout`` is the lane-aligned ``(T, S, 128)`` chunk/sublane/lane shape
the count-sketch kernels consume (ops/sketch.py). In a sketch-mode round the
PS weights stay resident in it; a resident chunked tensor carries **zeros in
its padded tail** (coordinates >= d), and the one nonlinear producer (the
sketch query, whose tail cells are hash noise) is masked by ``mask_tail``.

``ParamLayout`` is the model's flat parameter vector in **JAX ravel order**
(``jax.flatten_util.ravel_pytree`` of the flax parameter tree): leaves in
sorted-path order, each raveled C-order in the flax shape (conv kernels
HWIO, dense kernels ``(in, out)``). The sketch depends on coordinate order
(which coordinates share a chunk, and each one's sign index), so the port
keeps exactly this order. The torch module's own parameters are views of
the flat vector with a ``permute``, so the gradient of the flat leaf is the
gradient in JAX order with no copy loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

LANES = 128


@dataclass(frozen=True)
class ChunkLayout:
    """Geometry of the ``(T, S, 128)`` chunked resident layout of a
    ``(d,)`` vector: T chunks of S sublanes x 128 lanes, zero-padded tail."""

    d: int
    T: int
    S: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.T, self.S, LANES)

    @property
    def padded_size(self) -> int:
        return self.T * self.S * LANES

    def chunk(self, v: torch.Tensor) -> torch.Tensor:
        """``(d,)`` -> ``(T, S, 128)`` with a zero tail (dtype-preserving)."""
        assert v.shape == (self.d,), (tuple(v.shape), self.d)
        out = v.new_zeros(self.padded_size)
        out[: self.d] = v
        return out.view(self.shape)

    def unchunk(self, c3: torch.Tensor) -> torch.Tensor:
        """``(T, S, 128)`` -> ``(d,)`` (drops the padded tail; a view)."""
        assert tuple(c3.shape) == self.shape, (tuple(c3.shape), self.shape)
        return c3.reshape(self.padded_size)[: self.d]

    def mask_tail(self, c3: torch.Tensor) -> torch.Tensor:
        """Zero the padded-tail positions (coordinates >= d)."""
        if self.padded_size == self.d:
            return c3
        keep = self.flat_index(c3.device) < self.d
        return torch.where(keep, c3, torch.zeros((), dtype=c3.dtype,
                                                 device=c3.device))

    def flat_index(self, device) -> torch.Tensor:
        """int64 ``(T, S, 128)`` tensor of each position's flat index."""
        return torch.arange(self.padded_size, device=device).view(self.shape)


def jax_to_torch_layout(x: torch.Tensor) -> torch.Tensor:
    """A leaf in the flax layout -> the torch module's layout (a view):
    conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in)."""
    if x.ndim == 4:
        return x.permute(3, 2, 0, 1)
    if x.ndim == 2:
        return x.t()
    return x


def torch_to_jax_layout(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``jax_to_torch_layout`` (a view)."""
    if x.ndim == 4:
        return x.permute(2, 3, 1, 0)
    if x.ndim == 2:
        return x.t()
    return x


class ParamEntry(NamedTuple):
    """One parameter leaf's place in the JAX-order flat vector."""

    jax_path: Tuple[str, ...]   # flax path, e.g. ("prep", "Conv_0", "kernel")
    torch_name: str             # module parameter name, e.g. "prep.conv.weight"
    jax_shape: Tuple[int, ...]  # the leaf's shape in the flax layout
    offset: int
    size: int


class ParamLayout:
    """The model's flat parameter vector in JAX ravel order.

    Built from a module that names each of its parameters' flax path
    (``model.jax_param_path(torch_name)``). ``params(w)`` turns a flat
    ``(d,)`` tensor into the ``{torch_name: view}`` dict that
    ``torch.func.functional_call`` takes; autograd through those views
    lands the gradient on ``w`` in JAX order."""

    def __init__(self, model: torch.nn.Module):
        entries = []
        for name, p in model.named_parameters():
            jax_shape = tuple(torch_to_jax_layout(p.detach()).shape)
            entries.append((tuple(model.jax_param_path(name)), name,
                            jax_shape))
        # ravel_pytree flattens dicts with their keys sorted at every
        # level, which is the lexicographic order of the path tuples
        entries.sort(key=lambda e: e[0])
        out, offset = [], 0
        for path, name, shape in entries:
            n = 1
            for s in shape:
                n *= s
            out.append(ParamEntry(path, name, shape, offset, n))
            offset += n
        self.entries: Tuple[ParamEntry, ...] = tuple(out)
        self.d = offset

    def params(self, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flat ``(d,)`` -> ``{torch_name: torch-layout view of w}``."""
        assert w.shape == (self.d,), (tuple(w.shape), self.d)
        return {e.torch_name: jax_to_torch_layout(
                    w[e.offset:e.offset + e.size].view(e.jax_shape))
                for e in self.entries}

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``{torch_name: torch-layout tensor}`` -> flat ``(d,)`` float32
        in JAX ravel order (a copy)."""
        return torch.cat([
            torch_to_jax_layout(params[e.torch_name].detach()).reshape(-1)
            for e in self.entries]).to(torch.float32)
