"""The flat parameter vector both sides share: every leaf in its flax
layout (a conv kernel HWIO, a dense kernel ``(in, out)``, the rest as
declared), the leaves in JAX ravel order (``ravel_pytree`` sorts dict keys
at every level, which is the lexicographic order of the path tuples), and
the seeded initial weights drawn on the device in a few large calls."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


class Layout:
    """Offsets of the leaves ``[(path, shape), ...]`` in the flat vector."""

    def __init__(self, leaves: Sequence[Tuple[Path, Tuple[int, ...]]]):
        entries = sorted((tuple(p), tuple(int(s) for s in sh))
                         for p, sh in leaves)
        self.paths: List[Path] = [p for p, _ in entries]
        self.shapes = [sh for _, sh in entries]
        self.sizes = [math.prod(sh) for sh in self.shapes]
        self.offsets = list(np.cumsum([0] + self.sizes[:-1]).tolist())
        self.d = int(sum(self.sizes))

    def split(self, flat: torch.Tensor) -> Dict[Path, torch.Tensor]:
        """``{path: view of flat in the leaf's shape}``."""
        assert flat.shape == (self.d,), (tuple(flat.shape), self.d)
        return {p: flat[o:o + n].view(sh) for p, o, n, sh in
                zip(self.paths, self.offsets, self.sizes, self.shapes)}

    def leaf_norms(self, flat: torch.Tensor) -> np.ndarray:
        """The L2 norm of each leaf, in float64, in layout order."""
        flat = flat.reshape(-1)[:self.d].to(torch.float64)
        return np.array([float(torch.linalg.vector_norm(flat[o:o + n]))
                         for o, n in zip(self.offsets, self.sizes)])


def initial_weights(layout: Layout, init_rule, cfg: dict, seed: int,
                    device) -> torch.Tensor:
    """The ``(d,)`` float32 initial weights from ``seed``: one normal and
    one uniform draw of ``d`` values from a generator on ``device``, each
    leaf then scaled in place by its rule (``init_rule(path, shape, cfg)``
    gives ``("normal", std)``, ``("uniform", bound)`` or ``("const",
    value)``)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    normal = torch.randn(layout.d, generator=gen, device=dev)
    uniform = torch.rand(layout.d, generator=gen, device=dev)
    flat = torch.empty(layout.d, device=dev)
    for p, o, n, sh in zip(layout.paths, layout.offsets, layout.sizes,
                           layout.shapes):
        kind, v = init_rule(p, sh, cfg)
        out = flat[o:o + n]
        if kind == "normal":
            torch.mul(normal[o:o + n], v, out=out)
        elif kind == "uniform":
            torch.mul(uniform[o:o + n], 2.0 * v, out=out).sub_(v)
        elif kind == "const":
            out.fill_(v)
        else:
            raise ValueError(f"unknown init rule {kind!r} for {p}")
    return flat
