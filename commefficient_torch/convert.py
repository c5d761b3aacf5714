"""Carry weights between the JAX package and the port.

The port's flat parameter vector follows ``jax.flatten_util.ravel_pytree``
order and element layout (ops/flat.ParamLayout), so a JAX flat vector IS a
port flat vector; only the per-leaf trees differ in layout (conv kernels
HWIO in flax, OIHW in torch; the dense kernel ``(in, out)`` in flax,
``(out, in)`` in torch). Under ``--batchnorm`` the BatchNorm ``scale`` and
``bias`` are 1-D leaves of the same vector, and the running statistics
cross as the model state, keyed by their flax ``batch_stats`` paths.
Everything crosses as numpy arrays: this module imports neither JAX nor
flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from commefficient_torch.ops.flat import (
    ParamLayout,
    jax_to_torch_layout,
    torch_to_jax_layout,
)


def flat_from_jax(np_flat, layout: ParamLayout, device="cpu") -> torch.Tensor:
    """The JAX package's raveled parameter vector (numpy) -> the port's
    flat ``(d,)`` float32 tensor (the same values, same order)."""
    arr = np.asarray(np_flat, np.float32)
    if arr.shape != (layout.d,):
        raise ValueError(f"flat vector of shape {arr.shape}, the model has "
                         f"d = {layout.d}")
    return torch.from_numpy(arr.copy()).to(device)


def _leaves(tree: Mapping, prefix=()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def params_from_flax(np_tree: Mapping, layout: ParamLayout,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """A flax parameter tree of numpy arrays -> ``{torch_name: tensor}`` in
    the torch modules' layouts."""
    by_path = {e.jax_path: e for e in layout.entries}
    out = {}
    for path, leaf in _leaves(np_tree):
        if path not in by_path:
            raise KeyError(f"flax leaf {'/'.join(path)} has no port parameter")
        e = by_path[path]
        arr = np.asarray(leaf, np.float32)
        if arr.shape != e.jax_shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {e.jax_shape}")
        out[e.torch_name] = jax_to_torch_layout(
            torch.from_numpy(arr.copy()), e.kind).contiguous().to(device)
    missing = set(e.torch_name for e in layout.entries) - set(out)
    if missing:
        raise KeyError(f"flax tree lacks {sorted(missing)}")
    return out


def flax_from_port(params: Mapping[str, torch.Tensor],
                   layout: ParamLayout) -> Dict[str, Any]:
    """``{torch_name: tensor}`` -> a nested flax parameter tree of numpy
    arrays (the inverse of ``params_from_flax``)."""
    tree: Dict[str, Any] = {}
    for e in layout.entries:
        node = tree
        for key in e.jax_path[:-1]:
            node = node.setdefault(key, {})
        node[e.jax_path[-1]] = torch_to_jax_layout(
            params[e.torch_name].detach().cpu(), e.kind).contiguous().numpy()
    return tree


def model_state_from_flax(np_tree: Mapping, device="cpu"
                          ) -> Dict[str, torch.Tensor]:
    """A flax ``batch_stats`` tree (numpy) -> the port's model state:
    ``{"<flax path>/BatchNorm_0/{mean,var}": float32 tensor}``."""
    return {"/".join(path): torch.from_numpy(
                np.asarray(leaf, np.float32).copy()).to(device)
            for path, leaf in _leaves(np_tree)}

