"""The port's run report (``commefficient_torch/scripts/obs_report.py``)
against the JAX package's ``scripts/obs_report.py`` (unedited, imported
from its file) on the CPU.

- Byte-equal stdout, the same return code and the same JSON tail in
  every mode: the report and ``--json`` on each log, ``--compare`` on
  pairs of logs, ``--fleet`` (report and ``--json``), ``follow`` over a
  finished log and over a log with a torn trailing line, and the error
  exits.
- The logs: a tiny port ``cv_train`` run with ``--guards --inject_fault
  3:nan --trace_rounds 2:2`` (written under ``tmp_path`` through
  ``COMMEFFICIENT_RUN_DIR``), the same log cut inside its last line, and
  hand-built event streams, drawn from a seeded numpy generator, for the
  supervisor, fleet, serving, async, host-offload, churn and ICI/DCN
  sections (and the watch, guard and lifecycle sections beside them).
- No module under ``commefficient_torch/`` imports ``jax`` or
  ``commefficient_tpu``, no message of the port sends a user to the JAX
  package's renderer, and ``python -m
  commefficient_torch.scripts.obs_report`` renders a log with neither in
  ``sys.modules``.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_torch.scripts import obs_report as port_obs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread while this module runs
    (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_obs():
    spec = importlib.util.spec_from_file_location(
        "jax_obs_report", os.path.join(ROOT, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the logs --------------------------------------------------------------

def _cv_run(tmp) -> str:
    """The README's guarded CPU run: a poisoned round 3 and a trace of
    rounds 2-3, its run directory under ``tmp``."""
    from commefficient_torch import cv_train

    run = os.path.join(tmp, "cv_run")
    env = {"COMMEFFICIENT_RUN_DIR": run,
           "COMMEFFICIENT_SYNTHETIC_PER_CLASS": "8",
           "COMMEFFICIENT_TINY_MODEL": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cv_train.main([
                "--device", "cpu", "--dataset_name", "CIFAR10",
                "--dataset_dir", os.path.join(tmp, "d"),
                "--num_epochs", "1", "--num_workers", "2",
                "--local_batch_size", "4", "--iid", "--num_clients", "4",
                "--mode", "sketch", "--error_type", "virtual",
                "--local_momentum", "0", "--virtual_momentum", "0.9",
                "--k", "500", "--num_cols", "2048", "--num_rows", "3",
                "--lr_scale", "0.01", "--pivot_epoch", "0.5", "--seed", "0",
                "--guards", "--inject_fault", "3:nan",
                "--trace_rounds", "2:2"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return run


class _Stream:
    """A hand-built event log: seeded values, a clock, one event a call."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.t = 1000.0 + seed
        self.events = []

    def ms(self, scale=10.0):
        return float(self.rng.uniform(0.01, 1.0) * scale)

    def add(self, ev, **fields):
        self.t += float(self.rng.uniform(0.01, 0.5))
        self.events.append({"ev": ev, "t": round(self.t, 6), **fields})

    def rounds(self, n, **per_round):
        """``n`` drained rounds with spans, losses and metrics;
        ``per_round`` maps a field to a function of the round index."""
        for i in range(n):
            t_dispatch = round(self.t + 0.001, 6)
            fields = {"round": i, "t_dispatch": t_dispatch,
                      "dispatch_ms": self.ms(), "compute_ms": self.ms(40),
                      "drain_fetch_ms": self.ms(2),
                      "dispatch_to_drain_ms": self.ms(80),
                      "occupancy": int(self.rng.integers(1, 3)),
                      "loss": float(self.rng.uniform(0.5, 2.5)),
                      "guard_ok": True,
                      "metrics": {"update_nnz": 500.0,
                                  "topk_threshold": self.ms(1e-2),
                                  "error_norm": self.ms(3)}}
            for key, fn in per_round.items():
                fields[key] = fn(i)
            self.add("round", **fields)

    def write(self, path):
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")
        return path


WATCH = ["loss>ewma*4@2->trace", "error_norm>ewma*8@3",
         "io_error>0.5->checkpoint"]


def _ici_dcn(path):
    """A 2-D run's log: per-axis ledger legs, the mesh, quantized carries,
    schema-v3 histograms with non-finite values, alerts of every action,
    guard trips, a rollback and a fatal, lifecycle events, a partial
    round, an unknown kind and a record without ``ev``."""
    s = _Stream(1)
    s.add("run_start", entrypoint="cv_train", mode="sketch",
          grad_size=6568640, guards=True, backend="cuda",
          collective_plan="uplink=ici:fp32/dcn:int8",
          mesh={"axes": [{"name": "clients", "size": 2, "placement": "dcn"},
                         {"name": "shard", "size": 2, "placement": "ici"}],
                "process_count": 4, "nodes": 2},
          ledger={"client_uplink": {"bytes_per_round": 10000000,
                                    "collective": "transmit",
                                    "dtype": "float32"},
                  "transmit_reduce": {
                      "bytes_per_round": 6250000,
                      "collective": "hierarchical_psum (per-axis)",
                      "dtype": "mixed",
                      "bytes_per_axis": {
                          "shard": {"bytes_per_round": 5000000,
                                    "dtype": "float32",
                                    "placement": "ici"},
                          "clients": {"bytes_per_round": 1250000,
                                      "dtype": "int8",
                                      "placement": "dcn"}}},
                  "downlink": {"bytes_per_round": 2500000,
                               "collective": "all_gather"}},
          watch=WATCH, schema=["loss", "update_nnz"] * 5)

    def metrics(i):
        m = {"update_nnz": 50000.0, "topk_threshold": s.ms(1e-3),
             "error_norm": "nan" if i == 5 else s.ms(3),
             "qres_norm": s.ms(1), "dres_norm": s.ms(1)}
        for b in range(8):
            m[f"update_hist_{b}"] = float(s.rng.integers(0, 9000))
            m[f"error_hist_{b}"] = "inf" if (b, i) == (3, 2) else float(
                s.rng.integers(0, 90000))
        return m

    s.rounds(4, metrics=metrics)
    s.add("watch_alert", round=2, rule="loss>ewma*4@2->trace",
          value=9.25, bound=4.0, action="trace", trace_requested=True)
    s.add("watch_alert", round=3, rule="loss>ewma*4@2->trace",
          value=8.0, bound=4.5, action="trace", trace_requested=False)
    s.add("watch_alert", round=3, rule="io_error>0.5->checkpoint",
          value=1.0, bound=0.5, action="checkpoint")
    s.add("watch_alert", round=4, rule="error_norm>ewma*8@3",
          value=1e9, bound=7.5, action="log")
    s.add("trace_captured", round_start=3, round_until=4,
          dir="runs/x/trace_round_000003")
    s.add("guard_trip", round=5, trip=1, consecutive=1)
    s.rounds(2, guard_ok=lambda i: i != 1, metrics=metrics)
    s.add("guard_trip", round=6, trip=2, consecutive=2)
    s.add("rollback", round=6, consecutive=2)
    s.add("guard_fatal", round=7)
    s.add("checkpoint", round=6, path="ckpt/run_state_ep1_r6.npz")
    s.add("resume", start_epoch=1, mid_epoch=True)
    s.add("epoch", epoch=1, lr=0.1, train_loss=1.25)
    s.add("drain", rounds=8)
    s.add("round_partial", round=8)
    s.add("from_a_newer_schema", payload=[1, 2])
    s.events.append({"no_ev": True})
    s.add("run_end", rounds=8)
    return s.write(path)


def _supervisor(path):
    s = _Stream(2)
    s.add("supervisor_launch", attempt=1, pids=[101])
    s.add("supervisor_child_exit", rc=-9, hang=False, last_round=12)
    s.add("supervisor_restart", reason="crash", backoff_s=0.5)
    s.add("supervisor_launch", attempt=2, pids=[102])
    s.add("supervisor_timeout", silent_s=30.0, last_round=15)
    s.add("supervisor_child_exit", rc=-9, hang=True, last_round=15)
    s.add("supervisor_poison", path="ckpt/run_state_ep2_r15.npz")
    s.add("supervisor_restart", reason="hang", backoff_s=1.0)
    s.add("supervisor_launch", attempt=3, pids=[103])
    s.add("supervisor_child_exit", rc=0, hang=False, last_round=40)
    s.add("supervisor_done", rc=0)
    return s.write(path)


def _serving(path):
    s = _Stream(3)
    s.add("serving_start", owner="serve-7", checkpoint_path="ckpt/")
    for version in (4, 9, 13):
        s.add("serving_swap", model_version=version, load_ms=s.ms(300))
        for op in ("stat", "predict", "stat"):
            s.add("serving_answer", op=op, model_version=version,
                  latency_ms=s.ms(20))
    s.add("serving_answer", op="predict", model_version=13,
          latency_ms=s.ms(20), error="no such client")
    s.add("serving_stop", answered=10, errors=1, swaps=3, model_version=13)
    return s.write(path)


def _async(path):
    s = _Stream(4)
    s.add("run_start", entrypoint="cv_train", mode="sketch", grad_size=232812,
          guards=False, backend="cpu", participation="0.75",
          participation_sampling="uniform", staleness_decay=0.8,
          client_fault={"spec": "slow=0.2,delay=2,seed=7"},
          **{"async": {"buffer": 3, "staleness_decay": 0.8}})

    def cohort(i):
        folded = int(i % 3 == 2)
        return {"participants": 6, "target": 6, "dropped": i % 2,
                "slow": int(i % 4 == 1), "corrupt": int(i == 5),
                "requeued": i % 2, "abandoned": 0,
                "landed": ([{"delay": 2, "weight": 0.64}] if i % 4 == 3
                           else []),
                "retry_attempts": [1] * (i % 2) + [2] * int(i == 4),
                "staleness_mean": float(i % 3), "staleness_max": i % 3,
                "quarantined_total": int(i >= 5), "fault_skip": i == 6,
                "async": {"folded": 3 * folded, "version": i // 3,
                          "depth": i % 3, "masked": int(i == 5),
                          "staleness": ([{"delay": 0, "weight": 1.0},
                                         {"delay": 1, "weight": 0.8},
                                         {"delay": 2, "weight": 0.64}]
                                        if folded else [])}}
    s.rounds(9, cohort=cohort)
    s.add("straggler_expired", count=2)
    s.add("async_expired", count=1)
    s.add("run_end", rounds=9)
    return s.write(path)


def _host_offload(path):
    s = _Stream(5)
    s.add("run_start", entrypoint="cv_train", mode="sketch", grad_size=6568640,
          guards=False, backend="cuda", state_placement="disk",
          state_rows_per_round=8, state_row_bytes=26274560,
          state_slot_bytes=52549120,
          state_io={"queue_bound": 64, "retries": 3, "backoff_ms": 5.0,
                    "deadline_ms": 30000.0, "quarantine_after": 3,
                    "checksums": True, "scrub_rows": 8,
                    "inject": "eio=0.02,seed=3"})
    s.rounds(8, offload=lambda i: {
        "tier": "disk", "prefetch": ("hit", "miss", "off")[i % 3],
        "gather_ms": s.ms(), "gather_io_ms": s.ms(), "scatter_ms": s.ms(),
        "scatter_io_ms": s.ms(), "io_retries": i % 2,
        "io_errors": int(i == 6), "scrub_rows": 8,
        "scrub_mismatch": int(i == 4), "queue_depth": i % 4,
        "queue_age_ms": s.ms(50)})
    s.add("row_corrupt", row=17, member="velocities", round=4, where="scrub")
    s.add("row_repaired", row=17, member="velocities", round=4,
          source="snapshot")
    s.add("row_repaired", row=23, member="errors", round=5, source="mirror")
    s.add("row_quarantined", row=31, round=6, op="read", cause="EIO x3")
    s.add("io_counters", injected={"flip": 2, "storn": 1, "eio": 4})
    s.add("io_fatal", error="row 31: 3 failed reads; run state saved")
    return s.write(path)


def _churn(path):
    s = _Stream(6)
    s.add("run_start", entrypoint="cv_train", mode="sketch", grad_size=6568640,
          guards=False, backend="cuda",
          churn={"spec": "join=2,depart=1.5,init=0.5,seed=3,compact=4",
                 "join": 2.0, "depart": 1.5, "init": 0.5, "seed": 3,
                 "compact": 4})
    pop = 100
    for r in range(6):
        joins = [int(x) for x in s.rng.integers(200, 300, size=2)]
        pop += len(joins)
        s.add("churn_join", churn_round=r, population=pop, clients=joins)
        if r % 2:
            pop -= 1
            s.add("churn_depart", churn_round=r, population=pop,
                  clients=[int(s.rng.integers(0, 100))])
    s.rounds(6)
    s.add("cohort_short", round=3, target=8, got=6)
    s.add("rows_retired", rows=3)
    s.add("rows_compacted", moved=12, holes_reclaimed=4, ms=s.ms(200))
    s.add("churn_audit", registered=112, active=109, departed=3,
          quarantined=0, ok=True, idle_rounds=1)
    s.add("run_end", rounds=6)
    return s.write(path)


def _fleet(path):
    s = _Stream(7)
    s.add("fleet_start", tenants=3, max_concurrent=2,
          cache_dir="runs/fleet/cache", warm_admission=True)
    for i in range(3):
        s.add("tenant_admit", tenant=i, label=f"headline-{i}")
        s.add("tenant_start", tenant=i, attempt=1)
    for beat in range(1, 4):
        for i in range(3):
            s.add("tenant_progress", tenant=i, round=beat * 5, beats=beat)
    s.add("tenant_throttle", tenant=1)
    s.add("tenant_unthrottle", tenant=1)
    s.add("tenant_exit", tenant=1, last_round=17, rc=-9)
    s.add("tenant_restart", tenant=1)
    s.add("tenant_start", tenant=1, attempt=2)
    s.add("tenant_poison", tenant=2, path="t2/ckpt/run_state_ep0_r5.npz")
    s.add("tenant_giveup", tenant=2)
    s.add("tenant_finish", tenant=0, rounds=20)
    s.add("tenant_finish", tenant=1, rounds=20)
    s.add("fleet_done", admitted=3, finished=2, gave_up=1, restarts=1,
          total_rounds=55, wall_s=12.5, rounds_per_sec=4.4)
    return s.write(path)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("obs_logs"))
    out = {"cv_run": _cv_run(tmp)}
    for name, build in (("ici_dcn", _ici_dcn), ("supervisor", _supervisor),
                        ("serving", _serving), ("async", _async),
                        ("host_offload", _host_offload), ("churn", _churn)):
        out[name] = build(os.path.join(tmp, f"{name}.jsonl"))
    fleet_dir = os.path.join(tmp, "fleet")
    os.makedirs(fleet_dir)
    _fleet(os.path.join(fleet_dir, "fleet_events.jsonl"))
    out["fleet"] = fleet_dir
    # the run's log cut inside its last line, and before its run_end
    with open(os.path.join(out["cv_run"], "telemetry.jsonl")) as f:
        lines = f.readlines()
    torn = os.path.join(tmp, "torn.jsonl")
    with open(torn, "w") as f:
        f.writelines(lines[:-3])
        f.write(lines[-3][:len(lines[-3]) // 2])
    out["torn"] = torn
    empty = os.path.join(tmp, "empty.jsonl")
    open(empty, "w").close()
    out["empty"] = empty
    out["missing"] = os.path.join(tmp, "missing.jsonl")
    return out


def _run(mod, fn, *args, **kwargs):
    """``mod.<fn>(...)``'s return value, stdout and stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = getattr(mod, fn)(*args, **kwargs)
    return rc, out.getvalue(), err.getvalue()


def _same(jax_obs, fn, *args, **kwargs):
    """The port and the JAX script print the same bytes and return the
    same value; returns the port's stdout."""
    want = _run(jax_obs, fn, *args, **kwargs)
    got = _run(port_obs, fn, *args, **kwargs)
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0] == want[0]
    return got[1]


def _tail(stdout: str) -> dict:
    return json.loads(stdout.rstrip("\n").rsplit("\n", 1)[-1])


LOGS = ("cv_run", "ici_dcn", "supervisor", "serving", "async",
        "host_offload", "churn", "torn")


@pytest.mark.parametrize("name", LOGS)
@pytest.mark.parametrize("flags", ([], ["--json"]), ids=("report", "json"))
def test_report_and_json_byte_equal(jax_obs, logs, name, flags):
    tail = _tail(_same(jax_obs, "main", [logs[name]] + flags))
    if name == "cv_run":
        assert tail["guard_trips"] == 1 and tail["tripped_rounds"] == [3]
        assert tail["trace_captures"][0]["round_start"] == 2
    if name == "torn":
        # the reader stops at the torn line: the run never ended
        assert tail["run_complete"] is False


@pytest.mark.parametrize("pair", (("cv_run", "ici_dcn"),
                                  ("async", "host_offload"),
                                  ("churn", "torn")))
def test_compare_byte_equal(jax_obs, logs, pair):
    stdout = _same(jax_obs, "main", ["--compare", logs[pair[0]],
                                     logs[pair[1]]])
    assert set(_tail(stdout)) == {"a", "b", "delta"}


@pytest.mark.parametrize("flags", ([], ["--json"]), ids=("report", "json"))
def test_fleet_byte_equal(jax_obs, logs, flags):
    stdout = _same(jax_obs, "main", ["--fleet", logs["fleet"]] + flags)
    tail = _tail(stdout)
    assert (tail["admitted"], tail["finished"], tail["gave_up"]) == (3, 2, 1)
    assert tail["conservation_ok"] is True


@pytest.mark.parametrize("name", ("torn", "cv_run", "ici_dcn"))
def test_follow_byte_equal(jax_obs, logs, name):
    """One ``follow`` pass (two polls, no wait): over a log with a torn
    trailing line it renders what arrived and prints the tail; over a
    finished log it stops at ``run_end``."""
    def follow(mod):
        buf = io.StringIO()
        rc = mod.follow(logs[name], out=buf, interval=0.0, max_iters=2)
        return rc, buf.getvalue()

    got, want = follow(port_obs), follow(jax_obs)
    assert got == want
    assert got[0] == 0 and _tail(got[1])["log_rounds"] > 0


def test_live_reader_holds_the_torn_line(jax_obs, logs, tmp_path):
    """The follow reader keeps a torn line until its newline lands, and
    skips a complete line that does not parse, as JAX's does."""
    path = str(tmp_path / "live.jsonl")
    with open(os.path.join(logs["cv_run"], "telemetry.jsonl")) as f:
        lines = f.readlines()
    readers = [mod.LiveReader(path) for mod in (port_obs, jax_obs)]
    steps = [lines[0] + lines[1][:7], lines[1][7:] + "{not json}\n",
             "".join(lines[2:])]
    for chunk in steps:
        with open(path, "a") as f:
            f.write(chunk)
        got, want = (r.poll() for r in readers)
        assert got == want
    assert readers[0].poll() == []


@pytest.mark.parametrize("argv", (["empty"], ["missing"], ["empty", "--json"],
                                  ["--compare", "cv_run"],
                                  ["--fleet", "empty"], ["--fleet", "missing"],
                                  ["cv_run", "ici_dcn"]),
                         ids=lambda a: "-".join(a))
def test_error_exits_equal(jax_obs, logs, argv):
    rc, _, err = _run(port_obs, "main", [logs.get(a, a) for a in argv])
    assert rc == 2 and err
    _same(jax_obs, "main", [logs.get(a, a) for a in argv])


def test_read_events_stops_at_torn_line_as_jax(jax_obs, logs):
    from commefficient_tpu.telemetry import read_events as j_read
    from commefficient_torch.telemetry import read_events as t_read

    assert list(t_read(logs["torn"])) == list(j_read(logs["torn"]))
    assert port_obs.load_events(logs["torn"]) == jax_obs.load_events(
        logs["torn"])


# ---- the port imports no JAX ------------------------------------------------

def _port_modules():
    base = os.path.join(ROOT, "commefficient_torch")
    for dirpath, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_port_imports_no_jax():
    """No module under ``commefficient_torch/`` (its ``scripts/``
    included) imports ``jax`` or ``commefficient_tpu``, at any depth."""
    bad = []
    for path in _port_modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib",
                                           "commefficient_tpu")]
    assert not bad
    assert any(p.endswith(os.path.join("scripts", "obs_report.py"))
               for p in _port_modules())


def test_no_pointer_to_the_jax_renderer():
    """The port's messages and docs name its own renderer: the JAX
    script's path appears only where the port's copy names its origin."""
    hits = []
    for path in _port_modules():
        with open(path) as f:
            text = f.read()
        if "scripts/obs_report.py" in text and not path.endswith(
                os.path.join("commefficient_torch", "scripts",
                             "obs_report.py")):
            hits.append(os.path.relpath(path, ROOT))
    assert not hits


def test_module_renders_without_jax(logs):
    """``python -m commefficient_torch.scripts.obs_report --json`` in a
    child with neither ``jax`` nor ``commefficient_tpu`` loaded at its
    end."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['obs_report', '--json', {logs['cv_run']!r}]\n"
        "try:\n"
        "    runpy.run_module('commefficient_torch.scripts.obs_report',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'commefficient_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _tail(proc.stdout)["guard_trips"] == 1
