"""The benchmark of the port (``commefficient_torch``) on NVIDIA cards.

    python3 -m fedbench.run --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` (``fedbench/harness.py``) on the card
this process starts on and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks`` (each
number the comparison with the reference took, beside its limit; also the
last lines on standard error).

It exits non-zero and prints no result where the card is missing or
holds fewer devices than the cell asks for, and where JAX, flax or the
JAX package is loaded in this process once the run is over.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``time.time()`` scale (``/proc``), or
    now where it cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = _process_start()

FORBIDDEN = ("jax", "jaxlib", "flax", "commefficient_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def _json_safe(x):
    """The result with non-finite floats as strings (JSON has no inf)."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from fedbench import harness, spec

    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fedbench: {a.workload} needs {cell.chips} CUDA device(s), "
              f"this process sees {n}", file=sys.stderr)
        return 3
    out = harness.run(cell, a.seed, a.seconds, bool(a.trace),
                      device="cuda", t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print("fedbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    print(json.dumps(_json_safe(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
