"""Flat-parameter-vector plumbing and the chunked resident layout.

``ChunkLayout`` is the lane-aligned ``(T, S, 128)`` chunk/sublane/lane shape
the count-sketch kernels consume (ops/sketch.py). In a sketch-mode round the
PS weights stay resident in it; a resident chunked tensor carries **zeros in
its padded tail** (coordinates >= d), and the one nonlinear producer (the
sketch query, whose tail cells are hash noise) writes them as +0.0: its
kernel masks them in the launch, its plain version through ``mask_tail``.

``ParamLayout`` is the model's flat parameter vector in **JAX ravel order**
(``jax.flatten_util.ravel_pytree`` of the flax parameter tree): leaves in
sorted-path order, each raveled C-order in the flax shape (conv kernels
HWIO, dense kernels ``(in, out)``). The sketch depends on coordinate order
(which coordinates share a chunk, and each one's sign index), so the port
keeps exactly this order. The torch module's own parameters are views of
the flat vector with a ``permute``. Which permute a leaf takes is the
module's declaration (``model.jax_param_kind(name)``: ``conv``, ``dense``
or ``asis``), never the leaf's rank: an embedding table is 2-D and stored
``(num, features)`` by flax and by ``nn.Embedding`` alike.

Every gradient is taken with respect to each leaf (``ParamLayout.leaves``:
views of the resident weights, the JAX package's ``chunked_unravel`` on
a chunked plane) and laid out flat once (``gather_grads``); the streaming
client phase (``--stream_sketch``) sketches every leaf gradient at its flat
offset (``leaf_segments``), one group of adjacent leaves per launch under
``--sketch_coalesce`` (``coalesce_segments``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple

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


# the leaf kinds a module declares for its parameters
LEAF_KINDS = ("conv", "dense", "asis")


def jax_to_torch_layout(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A leaf in the flax layout -> the torch module's layout (a view), by
    the leaf's declared ``kind``: ``conv`` kernels HWIO -> OIHW, ``dense``
    kernels (in, out) -> (out, in), ``asis`` leaves (biases, scales,
    embedding tables) unchanged."""
    if kind == "conv":
        return x.permute(3, 2, 0, 1)
    if kind == "dense":
        return x.t()
    if kind == "asis":
        return x
    raise ValueError(f"unknown leaf kind {kind!r}; expected one of "
                     f"{LEAF_KINDS}")


def torch_to_jax_layout(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Inverse of ``jax_to_torch_layout`` (a view)."""
    if kind == "conv":
        return x.permute(2, 3, 1, 0)
    if kind == "dense":
        return x.t()
    if kind == "asis":
        return x
    raise ValueError(f"unknown leaf kind {kind!r}; expected one of "
                     f"{LEAF_KINDS}")


class ParamEntry(NamedTuple):
    """One parameter leaf's place in the JAX-order flat vector."""

    jax_path: Tuple[str, ...]   # flax path, e.g. ("prep", "Conv_0", "kernel")
    torch_name: str             # module parameter name, e.g. "prep.conv.weight"
    jax_shape: Tuple[int, ...]  # the leaf's shape in the flax layout
    offset: int
    size: int
    kind: str                   # "conv", "dense" or "asis" (LEAF_KINDS)


class ParamLayout:
    """The model's flat parameter vector in JAX ravel order.

    Built from a module that names each of its parameters' flax path
    (``model.jax_param_path(torch_name)``) and layout kind
    (``model.jax_param_kind(torch_name)``). ``params(w)`` turns a flat
    ``(d,)`` tensor into the ``{torch_name: view}`` dict that
    ``torch.func.functional_call`` takes, for forwards without a
    gradient. A gradient is taken by leaf: ``leaves``, ``params_of`` and
    ``gather_grads``."""

    def __init__(self, model: torch.nn.Module):
        entries = []
        for name, p in model.named_parameters():
            kind = model.jax_param_kind(name)
            jax_shape = tuple(torch_to_jax_layout(p.detach(), kind).shape)
            entries.append((tuple(model.jax_param_path(name)), name,
                            jax_shape, kind))
        # ravel_pytree flattens dicts with their keys sorted at every
        # level, which is the lexicographic order of the path tuples
        # (so "h10" sorts before "h2")
        entries.sort(key=lambda e: e[0])
        out, offset = [], 0
        for path, name, shape, kind in entries:
            n = 1
            for s in shape:
                n *= s
            out.append(ParamEntry(path, name, shape, offset, n, kind))
            offset += n
        self.entries: Tuple[ParamEntry, ...] = tuple(out)
        self.d = offset

    def params(self, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flat ``(d,)`` -> ``{torch_name: torch-layout view of w}``."""
        assert w.shape == (self.d,), (tuple(w.shape), self.d)
        return {e.torch_name: jax_to_torch_layout(
                    w[e.offset:e.offset + e.size].view(e.jax_shape), e.kind)
                for e in self.entries}

    def leaves(self, w: torch.Tensor) -> List[torch.Tensor]:
        """Flat ``(d,)`` -> one autograd leaf per parameter, in the flax
        layout: a view of ``w``, detached, with ``requires_grad``.
        ``torch.autograd.grad`` with respect to them returns one gradient
        per leaf; ``gather_grads`` lays them out flat. (Differentiating
        with respect to ``w`` through ``params(w)`` instead costs a
        d-sized zero fill and add per leaf in the backward pass.)"""
        assert w.shape == (self.d,), (tuple(w.shape), self.d)
        return [w[e.offset:e.offset + e.size].view(e.jax_shape).detach()
                .requires_grad_(True) for e in self.entries]

    def params_of(self, leaves) -> Dict[str, torch.Tensor]:
        """Leaves in the flax layout -> ``{torch_name: torch-layout
        view}``."""
        return {e.torch_name: jax_to_torch_layout(x, e.kind)
                for e, x in zip(self.entries, leaves)}

    def gather_grads(self, grads, out: torch.Tensor) -> torch.Tensor:
        """Write per-leaf gradients (flax layout, entry order) into the
        flat ``(d,)`` tensor ``out``, in JAX ravel order."""
        assert out.shape == (self.d,), (tuple(out.shape), self.d)
        return torch.cat([g.reshape(-1) for g in grads], out=out)

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``{torch_name: torch-layout tensor}`` -> flat ``(d,)`` float32
        in JAX ravel order (a copy)."""
        return torch.cat([
            torch_to_jax_layout(params[e.torch_name].detach(),
                                e.kind).reshape(-1)
            for e in self.entries]).to(torch.float32)


class LeafSegment(NamedTuple):
    """One parameter leaf's place in the flat layout (the JAX package's
    ``ops/flat.LeafSegment``)."""

    path: str    # '/'-joined lowercase flax path, e.g. "layer1/conv_0/kernel"
    offset: int  # flat element offset of the leaf's first element
    size: int    # number of elements


def leaf_segments(params: ParamLayout) -> Tuple[LeafSegment, ...]:
    """Per-leaf ``(path, offset, size)`` of the flat layout, leaves in
    offset order: the JAX package's ``leaf_segments`` of the flax tree
    (``ParamLayout.entries`` are already in its ravel order)."""
    return tuple(LeafSegment("/".join(e.jax_path).lower(), e.offset, e.size)
                 for e in params.entries)


class SegmentGroup(NamedTuple):
    """A contiguous run of leaves ``segs[start:stop]`` sketched with one
    launch; its flat span ``[offset, offset + size)`` is covered by the
    chunks ``[t_a, t_b)``."""

    start: int   # index of the first leaf in the group
    stop: int    # one past the last leaf index
    offset: int  # flat element offset of the group's first element
    size: int    # total elements (the leaves are contiguous)
    t_a: int     # first covering chunk
    t_b: int     # one past the last covering chunk (== t_a when size == 0)


def coalesce_segments(segs: Sequence[LeafSegment], vmem_budget: int, *,
                      chunk_elems: int) -> Tuple[SegmentGroup, ...]:
    """Greedy in-order grouping of adjacent leaves into covering
    chunk-range groups under a byte budget (the JAX package's
    ``coalesce_segments``, the same rules): a group grows while its
    covering chunk range ``[t_a, t_b)`` stays within ``vmem_budget`` bytes
    of float32 chunks (``chunk_elems`` = the sketch's ``c_pad``).

    - the groups partition the leaves in order;
    - zero-size leaves ride whichever group is current;
    - a single leaf whose covering range alone exceeds the budget forms
      its own group (one launch, as the per-leaf path);
    - when no group holds two nonzero leaves although two exist, one
      ``RuntimeWarning`` says the plan degenerated to per-leaf launches.
    """
    segs = tuple(segs)
    if not segs:
        return ()
    ce = int(chunk_elems)
    budget = int(vmem_budget)
    assert ce > 0, ce
    assert budget > 0, budget
    for a, b in zip(segs[:-1], segs[1:]):
        assert b.offset == a.offset + a.size, (a, b)

    def span_bytes(e0: int, e1: int) -> int:
        if e1 <= e0:
            return 0
        return (-(-e1 // ce) - e0 // ce) * ce * 4

    def mk(start: int, stop: int) -> SegmentGroup:
        e0 = segs[start].offset
        e1 = segs[stop - 1].offset + segs[stop - 1].size
        size = e1 - e0
        t_a = e0 // ce
        t_b = -(-e1 // ce) if size else t_a
        return SegmentGroup(start=start, stop=stop, offset=e0, size=size,
                            t_a=t_a, t_b=t_b)

    groups = []
    start = 0
    g_e0 = segs[0].offset
    cur_size = segs[0].size
    for i in range(1, len(segs)):
        s = segs[i]
        end = s.offset + s.size
        if (span_bytes(g_e0, end) <= budget or cur_size == 0
                or s.size == 0):
            cur_size += s.size
            continue
        groups.append(mk(start, i))
        start, g_e0, cur_size = i, s.offset, s.size
    groups.append(mk(start, len(segs)))

    n_nonzero = sum(1 for s in segs if s.size)
    multi = any(sum(1 for s in segs[g.start:g.stop] if s.size) > 1
                for g in groups)
    if n_nonzero > 1 and not multi:
        worst = max((g for g in groups if g.size),
                    key=lambda g: g.t_b - g.t_a)
        big = next(segs[i] for i in range(worst.start, worst.stop)
                   if segs[i].size)
        warnings.warn(
            f"coalesce_segments: budget {budget} B is smaller than every "
            f"leaf adjacency's covering chunk range (largest single leaf "
            f"{big.path!r}: {worst.t_b - worst.t_a} chunks "
            f"= {(worst.t_b - worst.t_a) * ce * 4} B); no adjacent "
            f"leaves coalesced — the plan degenerates to one per-leaf "
            f"launch each", RuntimeWarning)
    return tuple(groups)
