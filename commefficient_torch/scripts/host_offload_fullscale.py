"""The EMNIST-scale client state in host RAM, driven through the port's
``host`` tier: the port's copy of the JAX package's
``scripts/host_offload_fullscale.py``.

Geometry: 3,500 clients (the EMNIST population) of ``--error_type local``
sketch rows at the FetchSGD table geometry, 5 x 500,000 (c_pad 500,096,
10,001,920 bytes a row): 35,006,720,000 bytes of error rows, 32.60 GiB.
The plan comes from ``federated/memory.plan_client_state_memory`` with
its own probes (the device budget is half the card's memory, so at
32.6 GiB it picks ``hbm`` on an 80 GB card). The script exists to drive
the host tier, so it then forces it as the JAX script's CPU leg does:
the device budget set to 1 byte, the host budget pinned above the total
(``1 << 46``), and it prints that it did. Every row is written once
(``fill_``), so the resident set holds all of it: untouched pages of a
``calloc`` would not show.

Each of the rounds gathers W = 8 random rows (``np.random.default_rng(0)``)
through ``federated/host_state.RowStreamer`` (``gather_async``, pinned
staging, an upload on a side stream), adds ``round + 1`` to them on the
device, and scatters the deltas back (``scatter``, ``drain``). Then the
JAX script's spot check: four touched rows hold their summed deltas and
two untouched rows are zero.

    python -m commefficient_torch.scripts.host_offload_fullscale
    python -m commefficient_torch.scripts.host_offload_fullscale --device cpu

``HOST_OFFLOAD_TINY=1`` selects the JAX script's smoke geometry (48
clients, d = 9,973, 3 x 1,024, 3 rounds); ``HOST_OFFLOAD_ROUNDS`` sets
the rounds. Writes ``--out`` (default ``runs/host_offload_fullscale.json``;
nothing in tiny mode unless ``--out`` is given) and prints the result as
one JSON line. The full geometry needs about 33 GiB of host RAM.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import time

import numpy as np
import torch

from commefficient_torch.federated.host_state import RowStreamer
from commefficient_torch.federated.memory import (
    _device_hbm_budget,
    _host_ram_budget,
    plan_client_state_memory,
)
from commefficient_torch.federated.rounds import (
    ClientStates,
    init_client_states,
)
from commefficient_torch.federated.worker import WorkerConfig
from commefficient_torch.ops.sketch import make_sketch
from commefficient_torch.scripts.evidence import (
    RUNS,
    card_line,
    resolve_device,
    write_json,
)

# the EMNIST client count and the FetchSGD table geometry
NUM_CLIENTS = 3500
D = 6_568_640
ROWS, COLS = 5, 500_000
W = 8
TINY_GEOMETRY = (48, 9973, 3, 1024, 3)
# the JAX script's host budget pin, above any total here
HOST_BUDGET = 1 << 46


def geometry():
    """``(clients, d, rows, cols, rounds)`` from the environment."""
    rounds = int(os.environ.get("HOST_OFFLOAD_ROUNDS", "6"))
    if os.environ.get("HOST_OFFLOAD_TINY") == "1":
        return TINY_GEOMETRY
    return NUM_CLIENTS, D, ROWS, COLS, rounds


def rss_bytes() -> int:
    """The process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def mapping_resident_bytes(addr: int) -> int:
    """The resident bytes of the memory mapping that holds ``addr``
    (``Rss`` of its ``/proc/self/smaps`` entry): what of a large tensor's
    own pages is in RAM, whatever else the process holds or frees."""
    inside = False
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split(maxsplit=1)[0]
            if not head.endswith(":"):  # a mapping's address range
                lo, hi = (int(x, 16) for x in head.split("-"))
                inside = lo <= addr < hi
            elif inside and head == "Rss:":
                return int(line.split()[1]) * 1024
    raise ValueError(f"no mapping holds address {addr:#x}")


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 ** 2


def platform_of(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``."""
    if device.type == "cuda":
        return card_line() or torch.cuda.get_device_name(0)
    return "cpu"


def run(device: torch.device, log=print):
    """Allocate, write and stream the rows: the result dictionary and the
    rows (the CPU tensor of the error member)."""
    n, d, rows, cols, rounds = geometry()
    tiny = (n, d, rows, cols, rounds) == TINY_GEOMETRY
    wcfg = WorkerConfig(mode="sketch", error_type="local", k=50_000,
                        num_workers=W)
    sketch = make_sketch(d, c=cols, r=rows, seed=0, num_blocks=1,
                         device=device)
    r, c_pad = sketch.table_shape
    row_bytes = r * c_pad * 4
    log(f"[offload] platform={platform_of(device)} n={n} table={r}x{c_pad} "
        f"row={row_bytes / 1024 ** 2:.1f} MB "
        f"total={n * row_bytes / 1024 ** 3:.2f} GB")

    probed = plan_client_state_memory(n, d, wcfg, sketch=sketch,
                                      device=device)
    hbm_b = int(os.environ.get("COMMEFFICIENT_STATE_HBM_BUDGET")
                or _device_hbm_budget(device))
    host_b = int(os.environ.get("COMMEFFICIENT_STATE_HOST_BUDGET")
                 or _host_ram_budget())
    log(f"[offload] plan from the probes (device budget "
        f"{hbm_b / 2 ** 30:.2f} GiB, host budget {host_b / 2 ** 30:.2f} "
        f"GiB): {probed.summary()}")
    plan = plan_client_state_memory(n, d, wcfg, sketch=sketch,
                                    device=device, hbm_budget_bytes=1,
                                    host_budget_bytes=HOST_BUDGET)
    assert plan.placement == "host", plan
    assert plan.error_bytes == n * row_bytes, plan
    log(f"[offload] forced the host tier (device budget 1 B, host budget "
        f"{HOST_BUDGET} B): {plan.summary()}")

    t0 = time.perf_counter()
    states = init_client_states(n, d, wcfg, sketch=sketch, device="cpu")
    rss0 = rss_bytes()
    states.errors.fill_(0.0)  # every page written: the rows are resident
    alloc_s = time.perf_counter() - t0
    resident = mapping_resident_bytes(states.errors.data_ptr())
    log(f"[offload] allocated and wrote {states.errors.nbytes:,} B in "
        f"{alloc_s:.1f} s; the process resident {rss0 / 2 ** 30:.2f} -> "
        f"{rss_bytes() / 2 ** 30:.2f} GiB, the rows' mapping "
        f"{resident / 2 ** 30:.2f} GiB")

    streamer = RowStreamer(states, device)
    rng = np.random.default_rng(0)
    gather_ms, scatter_ms, touched = [], [], {}
    pinned = None
    try:
        for rd in range(rounds):
            ids = rng.choice(n, size=W, replace=False)
            t0 = time.perf_counter()
            stream = streamer.gather_async(ids).get()
            if stream.ready is not None:
                torch.cuda.current_stream(device).wait_event(stream.ready)
                torch.cuda.synchronize(device)
            g_ms = (time.perf_counter() - t0) * 1e3
            pinned = all(b.is_pinned() for b in stream.staged)
            # the round: a device-side delta on the gathered rows
            new = ClientStates(None, stream.proxy.errors + float(rd + 1),
                               None)
            t0 = time.perf_counter()
            streamer.scatter(stream, stream.proxy, new)
            streamer.drain()
            s_ms = (time.perf_counter() - t0) * 1e3
            gather_ms.append(g_ms)
            scatter_ms.append(s_ms)
            for i in ids:
                touched[int(i)] = touched.get(int(i), 0.0) + float(rd + 1)
            log(f"[offload] round {rd}: gather {g_ms:.1f} ms scatter "
                f"{s_ms:.1f} ms")

        # touched rows hold the summed deltas and two untouched rows are
        # zero, without reading the whole state back
        check = list(touched)[:4]
        untouched = [i for i in range(n) if i not in touched][:2]
        probe_ids = np.array(check + untouched
                             + [0] * (W - len(check) - len(untouched)))
        probe = streamer.gather_async(probe_ids).get()
        if probe.ready is not None:
            torch.cuda.current_stream(device).wait_event(probe.ready)
        errs = probe.proxy.errors
        for j, cid in enumerate(check):
            # every cell of the row, on the device
            want = torch.full_like(errs[j], touched[cid])
            assert torch.equal(errs[j], want), (cid, touched[cid])
        for j in range(len(check), len(check) + len(untouched)):
            assert not bool(errs[j].any()), \
                f"untouched row {untouched} nonzero"
        log("[offload] spot-check ok: deltas accumulated, untouched rows "
            "zero")
    finally:
        report = streamer.close()
    assert report["error"] is None and report["joined"], report

    # steady state: the median of rounds 1.., as the JAX script
    def med(xs):
        return float(np.median(xs[1:])) if len(xs) > 1 else xs[0]

    return {
        "platform": platform_of(device),
        "tiny": tiny,
        "num_clients": n,
        "padded_rows": n,
        "table": [r, c_pad],
        "row_mb": round(row_bytes / 1024 ** 2, 2),
        "total_gb": round(n * row_bytes / 1024 ** 3, 2),
        "placement": plan.placement,
        "memory_kind": (f"{states.errors.device.type} rows, "
                        f"{'pinned' if pinned else 'pageable'} staging"),
        "alloc_s": round(alloc_s, 2),
        "gather_ms_median": round(med(gather_ms), 2),
        "scatter_ms_median": round(med(scatter_ms), 2),
        "rounds": rounds,
        "rss_gb": round(peak_rss_gb(), 2),
        "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        # the port's keys
        "device": device.type,
        "probed_placement": probed.placement,
        "probed_plan": probed.summary(),
        "forced_tier": "host",
        "state_bytes": int(plan.error_bytes),
        "rows_device": states.errors.device.type,
        "staging_pinned": bool(pinned),
        # the resident bytes of the mapping that holds the rows
        "resident_bytes": resident,
        "resident_covers_state": resident >= plan.error_bytes,
        "gather_ms": gather_ms,
        "scatter_ms": scatter_ms,
        "spot_check": {"touched": {str(c): touched[c] for c in check},
                       "untouched": untouched, "ok": True},
    }, streamer.states.errors


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; refused without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="the JSON written (default: runs/"
                         "host_offload_fullscale.json, none in tiny mode)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "host_offload_fullscale")
    result, _ = run(device)
    assert result["resident_covers_state"], \
        (result["resident_bytes"], result["state_bytes"])
    out = args.out or (None if result["tiny"] else
                       os.path.join(RUNS, "host_offload_fullscale.json"))
    if out:
        write_json(out, result)
        print(f"[offload] wrote {out}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
