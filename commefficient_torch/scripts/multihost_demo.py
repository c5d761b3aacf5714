"""A federated round whose transmit sum crosses a node boundary: the
port's copy of the JAX package's ``scripts/multihost_demo.py``, through
the port's ``torchrun --nnodes`` seam.

The parent starts two "nodes" of 2 ranks each on this machine, each rank
a process with torchrun's environment (``RANK``, ``WORLD_SIZE`` 4,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` 2, ``MASTER_ADDR`` 127.0.0.1,
``MASTER_PORT``). Each rank reads it with ``parallel/mesh.world_from_env``,
starts the process group with ``init_distributed`` (gloo, numbered by the
grid's tuple index, as ``start_client_group`` does) and builds its client
grid; with ``LOCAL_WORLD_SIZE < WORLD_SIZE`` the clients axis spans the
nodes, so it is placed on ``dcn``. W = 8 slots, 2 a rank. Then:

  --mode {sketch,uncompressed}   the tiny sketched or dense round
                                 (``tiny_rounds.run_tiny_sketched_round``)
  --plan SPEC                    a ``--collective_plan`` spec, per-axis
                                 entries included (``dcn:int8``); a
                                 non-empty SPEC implies ``--server_shard``
  --engine                       instead of one round, the engine path
                                 (``tiny_rounds.run_tiny_engine``) on a
                                 2 x 2 clients x shard grid for 4 rounds,
                                 a run state written after round 2 (rank 0
                                 writes), which the parent then resumes
                                 elastically on its own one-rank group

Each rank prints ``sum`` / ``absmax`` / ``d`` of its weights and its kernel
launches; the ranks must agree bit for bit. The parent computes the same
run in one process (a one-rank group) and asserts the ranks' result
against it at the JAX script's ``rtol=1e-4``, and reports whether the two
are bit-equal. A failed or hung rank fails the run: the ranks share one
deadline (``CHILD_TIMEOUT``), a rank left behind by a failed sibling is
killed, and a rendezvous port taken between the pick and rank 0's bind is
retried with a fresh port (``BIND_ATTEMPTS``).

    python -m commefficient_torch.scripts.multihost_demo [--mode M]
        [--plan SPEC] [--engine] [--device cuda|cpu]

On the card every rank is a gloo rank on ``cuda:0`` (NCCL refuses two
ranks on one GPU, and gloo's point-to-point refuses CUDA tensors, so the
round's collectives are gloo's all-reduce and friends), with cuDNN held
to deterministic algorithms in every process; ``--device cpu`` runs gloo
on the CPU. Without a card it refuses to start unless
``--device cpu`` is given. ``main`` returns the parent's result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_NODES = 2
RANKS_PER_NODE = 2
WORLD = N_NODES * RANKS_PER_NODE
W = 8                      # client slots: 2 a rank
ENGINE_ROUNDS, ENGINE_SAVE_AT, ENGINE_SHARD = 4, 2, 2
CHILD_TIMEOUT = 300        # one deadline for all the ranks of a cohort
BIND_ATTEMPTS = 3          # rendezvous-port collision retries
RTOL, ATOL = 1e-4, 1e-6    # the JAX script's sum tolerance

# the cohort's legs ride in the environment, not the argv
_ENV_LEGS = "COMMEFFICIENT_DEMO_LEGS"
# the TCPStore's bind failure, as it appears in a rank's output
_BIND_MARKERS = ("EADDRINUSE", "address already in use")


def _free_port() -> int:
    """A TCP port free now. Racy (another process may take it before rank
    0 binds it): the parent retries the cohort on a detected bind
    failure."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _summary(w: np.ndarray) -> dict:
    return {"sum": float(w.sum()), "absmax": float(np.abs(w).max()),
            "d": int(w.size)}


def _launches(device) -> dict:
    from commefficient_torch import kernels

    return kernels.launch_counts() if device.type == "cuda" else {}


@contextlib.contextmanager
def _deterministic():
    """cuDNN on deterministic algorithms, no autotuning (restored after):
    on the card the ranks and the one-process run then differ only in the
    order of their fp32 sums."""
    import torch

    cudnn = torch.backends.cudnn
    old = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


def _reset_launches(device) -> None:
    from commefficient_torch import kernels

    if device.type == "cuda":
        kernels.library()
        kernels.reset_launch_counts()


def run_leg(leg: dict, group, device, save_dir: str | None = None):
    """The leg on ``group``: ``(weights, aux)``, ``aux`` the run state
    written (the engine; None unless ``save_dir``) or the initial weights
    (a round)."""
    from commefficient_torch.scripts.tiny_rounds import (
        run_tiny_engine,
        run_tiny_sketched_round,
    )

    if leg["engine"]:
        return run_tiny_engine(
            W, rounds=ENGINE_ROUNDS, shard_devices=leg["shard"],
            mode=leg["mode"], collective_plan=leg["plan"], group=group,
            device=device,
            save_path=os.path.join(save_dir, "rs") if save_dir else None,
            save_at=ENGINE_SAVE_AT if save_dir else None)
    return run_tiny_sketched_round(
        W, mode=leg["mode"], server_shard=bool(leg["plan"]),
        collective_plan=leg["plan"], group=group, device=device)


def _rank_leg(i: int, leg: dict, out_dir: str, device, env) -> None:
    """This rank's run of leg ``i`` on its own client grid: the weights to
    ``out_dir``, the result line to the standard output."""
    from commefficient_torch.parallel.mesh import (
        CLIENTS_AXIS,
        make_client_group,
    )

    group = make_client_group(W, WORLD // leg["shard"], device,
                              shard_devices=leg["shard"], nodes=env.nodes)
    placement = group.axis_placement()
    assert placement[CLIENTS_AXIS] == "dcn", placement
    _reset_launches(device)
    save_dir = os.path.join(out_dir, f"leg{i}") if leg["engine"] else None
    w, aux = run_leg(leg, group, device, save_dir=save_dir)
    out = {"leg": i, "rank": group.rank, "launcher_rank": env.rank,
           "node": env.rank // env.local_size, "placement": placement,
           "launches": _launches(device),
           "ckpt": aux if leg["engine"] else None, **_summary(w)}
    np.save(os.path.join(out_dir, f"w{i}_{group.rank}.npy"), w)
    print(f"RANK {group.rank} RESULT sum={out['sum']:.10e} "
          f"absmax={out['absmax']:.10e} d={out['d']} " + json.dumps(out),
          flush=True)


def child() -> None:
    """One rank of the cohort: its world from torchrun's environment, one
    process group for all the legs, a client grid a leg."""
    import torch

    from commefficient_torch.parallel.mesh import (
        CLIENTS_AXIS,
        SHARD_AXIS,
        destroy_distributed,
        grid_sizes,
        init_distributed,
        tuple_index,
        world_from_env,
    )

    cohort = json.loads(os.environ[_ENV_LEGS])
    env = world_from_env()
    assert env is not None and env.size == WORLD and env.nodes == N_NODES, \
        env
    # the process group is numbered by the tuple index of the widest grid
    # (the engine's 2 x 2), as start_client_group numbers it; the 1-D
    # grids are then laid over those ranks
    shard = max(leg["shard"] for leg in cohort["legs"])
    sizes = grid_sizes(W, WORLD // shard, shard, env.size)
    dev = cohort["device"]
    n_dev = torch.cuda.device_count() if dev == "cuda" else 1
    device = init_distributed(
        dev, backend="gloo",
        rank=tuple_index(env.rank, sizes[CLIENTS_AXIS], sizes[SHARD_AXIS]),
        world_size=env.size, local_rank=env.local_rank % max(1, n_dev))
    try:
        with _deterministic():
            for i, leg in enumerate(cohort["legs"]):
                _rank_leg(i, leg, cohort["dir"], device, env)
    finally:
        destroy_distributed()


def _cohort_env(cohort: dict, port: int, rank: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
               LOCAL_RANK=str(rank % RANKS_PER_NODE),
               LOCAL_WORLD_SIZE=str(RANKS_PER_NODE),
               GROUP_RANK=str(rank // RANKS_PER_NODE),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1")
    env[_ENV_LEGS] = json.dumps(cohort)
    env.pop("COMMEFFICIENT_NUM_PROCS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def run_cohort(cohort: dict, log=print, timeout=CHILD_TIMEOUT) -> list:
    """Start the 4 ranks against one rendezvous port and collect their
    output; retried with a fresh port on a bind failure. A rank that
    fails or outlives the shared deadline fails the cohort."""
    last = None
    for attempt in range(BIND_ATTEMPTS):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "commefficient_torch.scripts.multihost_demo", "--child"],
            env=_cohort_env(cohort, port, r), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        outs, failed = [], False
        # one deadline shared by the ranks, not one each
        deadline = time.monotonic() + timeout
        try:
            for i, p in enumerate(procs):
                remaining = max(1.0, deadline - time.monotonic())
                try:
                    out, _ = p.communicate(timeout=remaining)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    log(f"--- rank {i} (timed out after {remaining:.0f} s)"
                        f" ---\n{out}")
                    raise
                outs.append(out)
                if p.returncode != 0:
                    failed = True
                    log(f"--- rank {i} (exit {p.returncode}, attempt "
                        f"{attempt}) ---\n{out}")
                    break
        finally:
            # a rank that failed or hung must not leave its siblings
            # waiting in the rendezvous or a collective
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not failed:
            return outs
        last = outs
        if not any(m in o for o in outs for m in _BIND_MARKERS) \
                or attempt == BIND_ATTEMPTS - 1:
            break
        log(f"rendezvous bind race on port {port}: retrying "
            f"({attempt + 1}/{BIND_ATTEMPTS})")
    raise AssertionError("rank cohort failed:\n" + "\n".join(last or []))


def parse_results(outs: list, n_legs: int) -> list:
    """Each leg's rank results, in rank order; the ranks of a leg agree."""
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RANK ") and " RESULT " in line:
                res = json.loads(line[line.index("{"):])
                results[(res["leg"], res["rank"])] = res
    per_leg = []
    for i in range(n_legs):
        ranks = [results.get((i, r)) for r in range(WORLD)]
        assert all(ranks), f"leg {i}: missing rank results"
        key = [(x["sum"], x["absmax"], x["d"]) for x in ranks]
        assert len(set(key)) == 1, \
            f"leg {i}: ranks disagree on the replicated result: {key}"
        per_leg.append(ranks)
    return per_leg


def make_leg(mode="sketch", plan="", engine=False) -> dict:
    """A leg of ``demo``: the round (or, with ``engine``, the engine on
    the 2 x 2 grid) in ``mode`` under the plan ``plan``."""
    return {"mode": mode, "plan": plan, "engine": bool(engine),
            "shard": ENGINE_SHARD if engine else 1}


def check_leg(leg: dict, ranks: list, got: np.ndarray, device,
              log=print) -> dict:
    """The cohort's weights against the same leg in this process (a
    one-rank group), and the engine's elastic resume."""
    from commefficient_torch.scripts.tiny_rounds import (
        one_rank_group,
        run_tiny_engine,
    )

    mode, plan, engine = leg["mode"], leg["plan"], leg["engine"]
    _reset_launches(device)
    with one_rank_group(W, device, force_dcn="dcn" in plan) as g:
        ref, aux = run_leg(dict(leg, shard=1), g, device)
    ref_launches = _launches(device)
    assert got.size == ref.size
    np.testing.assert_allclose(got.sum(), ref.sum(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.abs(got).max(), np.abs(ref).max(),
                               rtol=RTOL, atol=1e-7)
    if not plan:
        # fp32: the same weights up to the order of the fp32 sums
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        if mode == "sketch" and not engine:
            # and the same kept set, bit for bit
            np.testing.assert_array_equal(got != aux, ref != aux)
    result = {
        "leg": "engine" if engine else "round", "mode": mode,
        "plan": plan or "fp32", "device": device.type, "ranks": ranks,
        "reference": _summary(ref), "reference_launches": ref_launches,
        "bit_equal_to_reference": bool(np.array_equal(got, ref)),
        "max_abs_diff": float(np.abs(got.astype(np.float64) - ref).max()),
    }
    if engine:
        # the run state the cohort wrote after round 2, restored on this
        # process's one-rank group (no shard axis), rounds 3-4
        ckpt = ranks[0]["ckpt"]
        assert ckpt and os.path.exists(ckpt), \
            "the engine cohort wrote no run state"
        _reset_launches(device)
        with one_rank_group(W, device) as g:
            elastic, _ = run_tiny_engine(
                W, rounds=ENGINE_ROUNDS, shard_devices=1, mode=mode,
                collective_plan=plan, group=g, device=device,
                resume_path=ckpt)
        result["elastic_launches"] = _launches(device)
        np.testing.assert_allclose(elastic.sum(), got.sum(), rtol=RTOL,
                                   atol=ATOL)
        result["elastic"] = _summary(elastic)
        result["elastic_bit_equal"] = bool(np.array_equal(elastic, got))
        log("ELASTIC RESUME OK: 2-node run state -> 1-process group")
    kind = result["leg"]
    log(f"MULTIHOST OK: 2-node x {RANKS_PER_NODE}-rank {kind} == "
        f"single-process {kind} (mode={mode} plan={plan or 'fp32'}; "
        f"sum {got.sum():.6e} vs {ref.sum():.6e}; bit-equal "
        f"{result['bit_equal_to_reference']})")
    return result


def demo(legs: list, device, log=print, timeout=CHILD_TIMEOUT) -> list:
    """One cohort of 2 nodes x 2 ranks runs ``legs`` (``make_leg``'s) in
    turn, its ranks within ``timeout`` seconds; each leg against the
    one-process run. The results, a leg each."""
    import torch

    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="multihost_demo_") as tmp, \
            _deterministic():
        cohort = {"legs": legs, "device": device.type, "dir": tmp}
        t0 = time.perf_counter()
        outs = run_cohort(cohort, log, timeout)
        cohort_s = time.perf_counter() - t0
        results = []
        for i, (leg, ranks) in enumerate(zip(legs, parse_results(
                outs, len(legs)))):
            ws = [np.load(os.path.join(tmp, f"w{i}_{r}.npy"))
                  for r in range(WORLD)]
            for r in range(1, WORLD):
                assert np.array_equal(ws[r], ws[0]), (i, r)
            results.append(check_leg(leg, ranks, ws[0], device, log))
    for res in results:
        res["cohort_s"] = cohort_s
    return results


def main(argv=None) -> dict:
    from commefficient_torch.scripts.evidence import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="sketch",
                    choices=["sketch", "uncompressed"])
    ap.add_argument("--plan", default="")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; refused without a card) or cpu")
    a = ap.parse_args(argv)
    device = resolve_device(a.device, "multihost_demo")
    result, = demo([make_leg(a.mode, a.plan, a.engine)], device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        main()
