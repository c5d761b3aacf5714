"""The one traffic generator: a traffic mix is a data file
(``fedbench/traffic/<mix>.json``) of the round's cohort and the fields of
each client's examples, and this module draws a pool of rounds from it.

A mix holds ``clients_per_round`` (W), ``examples_per_client`` (B),
``population`` (the clients a cohort is drawn from, without replacement),
``pool`` (distinct rounds drawn at set-up and fed in turn), ``fields``
(per field: ``shape`` of one client's part, ``dtype``, ``draw`` one of
``normal``, ``randint`` with ``low`` / ``high``), ``recipe`` (the
compression flags, which the configuration leaves to the mix: ``mode``,
``error_type``) and ``flags`` (further program flags of the mix). A mix
that ``extends`` another holds only the keys it sets anew. Every round
has the same sizes whatever the seed; only the values differ. The arrays are numpy, as
the program's loader hands them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _draw(rs: np.random.RandomState, spec: dict, shape) -> np.ndarray:
    kind = spec["draw"]
    if kind == "normal":
        out = rs.standard_normal(shape)
    elif kind == "randint":
        out = rs.randint(int(spec["low"]), int(spec["high"]), size=shape)
    else:
        raise ValueError(f"unknown draw {kind!r}")
    return out.astype(spec.get("dtype", "float32"))


def rounds(mix: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """``mix["pool"]`` rounds from ``seed``: each the fields with a
    leading client axis, ``mask`` (W, B) and ``worker_mask`` (W,) of
    ones, and ``client_ids``, W distinct clients of the population."""
    rs = np.random.RandomState(int(seed) % 2**32)
    W, B = int(mix["clients_per_round"]), int(mix["examples_per_client"])
    out = []
    for _ in range(int(mix["pool"])):
        b = {name: _draw(rs, spec, (W,) + tuple(spec["shape"]))
             for name, spec in mix["fields"].items()}
        b["mask"] = np.ones((W, B), np.float32)
        b["worker_mask"] = np.ones(W, np.float32)
        b["client_ids"] = rs.choice(int(mix["population"]), W,
                                    replace=False).astype(np.int32)
        out.append(b)
    return out
