"""The numbers that decide ``correct``: the program's first rounds against
the reference's, from the same weights and batches.

- ``first_loss_gap``: the largest relative gap of a client's loss in
  the first round, which both sides start from the same weights and
  batch;
- ``loss_gap``: the same over the later checked rounds, whose weights
  follow the first rounds' top-k cuts;
- ``grad_gap``: the first gradient as the server state holds it after one
  round (the velocity: the table's rows in sketch mode, the leaves of the
  dense vector otherwise), by the worst row or leaf: the gap of the two
  norms over the larger of the reference's norm and its median norm. In
  sketch mode the server zeroes the cells of the coordinates its top-k
  kept; where a coordinate's estimate lies at the cut to rounding, the
  two sides' cuts differ from run to run (the sums that fill a table run
  in no fixed order) and zero different cells. The table is compared
  over the cells that neither side zeroed, and ``zeroed_differ`` bounds
  the rest;
- ``zeroed_differ`` (sketch mode): the cells of that table that one side
  alone holds at exactly 0;
- ``change_gap``: the weights' change after the checked rounds, by the
  worst leaf in the same way, over the leaves that the reference's first
  gradient moves (a leaf whose gradient norm is under a thousandth of the
  median leaf's moves by round-off alone and is left out), against the
  median of the leaves the reference changed.

A gap where both norms are 0 is 0; a nonzero norm against a zero scale is
infinite. A cell compares the numbers that its limits file names.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

NAMES = ("first_loss_gap", "loss_gap", "grad_gap", "zeroed_differ",
         "change_gap")
GRAD_FLOOR = 1e-3


def _gaps(prog: np.ndarray, ref: np.ndarray, scale: float) -> np.ndarray:
    den = np.maximum(ref, scale)
    num = np.abs(prog - ref)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(num == 0, 0.0, num / den)
    return np.where((num > 0) & (den == 0), np.inf, out)


def _rows(t: torch.Tensor) -> np.ndarray:
    return torch.linalg.vector_norm(t.to(torch.float64), dim=1).numpy()


def numbers(prog: dict, ref: dict, layout, w0: torch.Tensor
            ) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses (rounds, W)``, ``velocity``,
    ``weights`` (flat, on the host); ``ref`` also ``grad_leaf_norms``;
    ``w0`` the initial weights on the host."""
    lp = np.asarray(prog["losses"], np.float64)
    lr = np.asarray(ref["losses"], np.float64)
    if lp.shape != lr.shape:
        first_loss_gap = loss_gap = np.inf
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            g = np.abs(lp - lr) / np.abs(lr)
        g = np.where(np.isnan(g), np.inf, g)
        first_loss_gap = float(np.max(g[0]))
        loss_gap = float(np.max(g[1:])) if len(g) > 1 else 0.0

    out = {"first_loss_gap": first_loss_gap, "loss_gap": loss_gap}
    vp, vr = prog["velocity"], ref["velocity"]
    if vr.dim() == 2:
        out["zeroed_differ"] = int(((vp == 0) ^ (vr == 0)).sum())
        both = (vp != 0) & (vr != 0)
        np_, nr = _rows(vp * both), _rows(vr * both)
    else:
        np_, nr = layout.leaf_norms(vp), layout.leaf_norms(vr)
    out["grad_gap"] = float(np.max(_gaps(np_, nr, float(np.median(nr)))))

    gn = ref["grad_leaf_norms"]
    moved = gn >= GRAD_FLOOR * np.median(gn)
    cp = layout.leaf_norms(prog["weights"] - w0)[moved]
    cr = layout.leaf_norms(ref["weights"] - w0)[moved]
    changed = cr[cr > 0]
    scale = float(np.median(changed)) if changed.size else 0.0
    out["change_gap"] = float(np.max(_gaps(cp, cr, scale)))
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``(every number that ``limits`` names within its limit, {name:
    {value, limit}})``; a number that is NaN or missing fails, and so
    do limits that name no number."""
    out, ok = {}, True
    for name in (n for n in NAMES if n in limits):
        v, lim = values.get(name, float("nan")), float(limits[name])
        out[name] = {"value": v, "limit": lim}
        ok = ok and bool(v <= lim)
    return ok and bool(out), out
