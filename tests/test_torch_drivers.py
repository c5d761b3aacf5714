"""The port's drivers (``commefficient_torch/scripts/``: ``supervise``,
``orchestrate``, ``crash_matrix``, ``serve``) against the JAX package's
``scripts/`` on the CPU.

- The supervisor: on the fake-child plans of ``tests/test_supervise.py``
  (python children, no model: a crash, a hang, beats that stay stale, a
  spent restart budget, a poisoned checkpoint) the port's ``supervise``
  gives JAX's return code, event kinds in order, restart and poison
  counts, backoff delays and each attempt's argv and exclusion list.
- The orchestrator: on the fake tenants of ``tests/test_packing.py``
  (bounded admission, warm admission, a tenant that crashes once, one
  that gives up, namespaces), the same admission order, each tenant's
  event kinds in order, and the same ``fleet_done`` counts; the port sets
  no ``JAX_*`` variable, and a ``-m`` child gets the interpreter.
- ``--procs 2`` gives the children torchrun's environment.
- The heartbeat: the port's ``parse_heartbeat`` reads JAX's lines and
  JAX's reads the port's, ``population=`` and ``serve_lag=`` included.
- ``crash_matrix``: a SIGKILL of a tiny CPU ``cv_train`` run and its
  ``--resume auto`` end bit-identical to the uninterrupted run (about
  15 s, so not marked slow), and its supervised helper signals the child
  the supervisor launched; ``serve`` answers a request in client mode.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from commefficient_tpu import profiling as jprof
from commefficient_torch import profiling as tprof
from commefficient_torch.scripts import crash_matrix as tcm
from commefficient_torch.scripts import orchestrate as torch_orch
from commefficient_torch.scripts import supervise as tsup
from tests.test_packing import _TENANT
from tests.test_packing import _load_script
from tests.test_supervise import _CHILD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jsup = _load_script("supervise")
jorch = _load_script("orchestrate")


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _supervise(mod, tmp, plan, **kw):
    tmp.mkdir()
    child = tmp / "child.py"
    child.write_text(_CHILD)
    (tmp / "plan.json").write_text(json.dumps(plan))
    for k, v in (("heartbeat_timeout", 2.0), ("startup_grace", 10.0),
                 ("backoff", 0.05), ("max_restarts", 5)):
        kw.setdefault(k, v)
    rc = mod.supervise([sys.executable, str(child), str(tmp / "plan.json"),
                        str(tmp / "state")],
                       events_path=str(tmp / "ev.jsonl"),
                       out=open(os.devnull, "w"), **kw)
    evs = _events(tmp / "ev.jsonl")
    attempts = {}
    for fn in os.listdir(tmp):
        if fn.startswith("state.attempt"):
            a = json.loads((tmp / fn).read_text())
            # the poisoned path lives under each run's own directory
            a["exclude"] = os.path.basename(a["exclude"])
            attempts[int(fn.rsplit("attempt", 1)[1])] = a
    return rc, evs, attempts


PLANS = {
    "crash": ([{"beats": 3, "rc": 1}, {"beats": 3, "rc": 0}], {}),
    "hang": ([{"beats": 2, "hang": True}, {"beats": 2, "rc": 0}],
             {"heartbeat_timeout": 1.0}),
    "stale": ([{"beats": 60, "beat_sleep": 0.02, "buf": 3, "stale": 50},
               {"beats": 2, "rc": 0}],
              {"heartbeat_timeout": 1.0, "max_stale": 10}),
    "giveup": ([{"rc": 3}], {"max_restarts": 2}),
    "backoff": ([{"rc": 1}], {"max_restarts": 3}),
    "poison": ([{"beats": 2, "rc": 1},
                {"resume_print": "POISON/run_state_ep2.npz", "rc": 1},
                {"resume_print": "POISON/run_state_ep2.npz", "rc": 1},
                {"beats": 1, "rc": 0}], {}),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_supervisor_matches_jax(tmp_path, name):
    plan, kw = PLANS[name]
    t = _supervise(tsup, tmp_path / "t", plan, **kw)
    j = _supervise(jsup, tmp_path / "j", plan, **kw)
    assert t[0] == j[0]
    kinds = [e["ev"] for e in j[1]]
    assert [e["ev"] for e in t[1]] == kinds
    for kind in ("supervisor_restart", "supervisor_poison",
                 "supervisor_giveup", "supervisor_timeout"):
        assert [{k: e[k] for k in ("backoff_s", "reason", "strikes",
                                   "restarts") if k in e}
                for e in t[1] if e["ev"] == kind] == \
            [{k: e[k] for k in ("backoff_s", "reason", "strikes",
                                "restarts") if k in e}
             for e in j[1] if e["ev"] == kind]
    # a child killed at the deadline may have beaten once more or less
    # (the stale plan beats until the kill lands): its count is not kept
    def exits(evs):
        return [(e["rc"], e["hang"], None if e["hang"] and name == "stale"
                 else e["rounds_seen"])
                for e in evs if e["ev"] == "supervisor_child_exit"]

    assert exits(t[1]) == exits(j[1])
    assert {k: v["argv"] for k, v in t[2].items()} == \
        {k: v["argv"] for k, v in j[2].items()}
    assert {k: v["exclude"] for k, v in t[2].items()} == \
        {k: v["exclude"] for k, v in j[2].items()}
    if name == "poison":
        assert "supervisor_poison" in kinds


def _fleet(mod, tmp, specs, **kw):
    tmp.mkdir()
    child = tmp / "tenant.py"
    child.write_text(_TENANT)
    tenants = [[sys.executable, str(child), str(tmp), str(b), str(s),
                str(-1 if c is None else c)] for b, s, c in specs]
    for k, v in (("heartbeat_timeout", 5.0), ("startup_grace", 30.0),
                 ("backoff", 0.05), ("max_restarts", 3),
                 ("share_cache", False), ("warm_admission", False),
                 ("namespace_args", False), ("poll", 0.05)):
        kw.setdefault(k, v)
    rc = mod.orchestrate(tenants, fleet_dir=str(tmp / "fleet"),
                         out=open(os.devnull, "w"), **kw)
    evs = _events(tmp / "fleet" / "fleet_events.jsonl")
    dumps = {}
    for fn in os.listdir(tmp):
        if fn.startswith("attempts_t") and ".attempt" in fn:
            tid, att = fn[len("attempts_t"):].split(".attempt")
            dumps[(int(tid), int(att))] = json.loads((tmp / fn).read_text())
    return rc, evs, dumps


def _per_tenant(evs):
    out = {}
    for e in evs:
        if "tenant" in e and e["ev"] != "tenant_progress":
            out.setdefault(e["tenant"], []).append(e["ev"])
    return out


FLEETS = {
    "bounded": ([(3, 0.1, None)] * 4, {"max_concurrent": 2}),
    "warm": ([(4, 0.05, None)] * 3, {"share_cache": True,
                                      "warm_admission": True}),
    "restart": ([(8, 0.1, None), (6, 0.1, 3), (8, 0.1, None)],
                {"backoff": 0.2}),
    "giveup": ([(3, 0.05, None), (0, 0.05, -2), (3, 0.05, None)],
               {"max_restarts": 1}),
    "namespace": ([(2, 0.05, None)] * 2, {"namespace_args": True}),
}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_orchestrator_matches_jax(tmp_path, name):
    specs, kw = FLEETS[name]
    t = _fleet(torch_orch, tmp_path / "t", specs, **kw)
    j = _fleet(jorch, tmp_path / "j", specs, **kw)
    assert t[0] == j[0]
    assert [e["tenant"] for e in t[1] if e["ev"] == "tenant_admit"] == \
        [e["tenant"] for e in j[1] if e["ev"] == "tenant_admit"]
    assert _per_tenant(t[1]) == _per_tenant(j[1])
    keys = ("admitted", "finished", "gave_up", "restarts", "total_rounds")
    tdone, jdone = t[1][-1], j[1][-1]
    assert tdone["ev"] == jdone["ev"] == "fleet_done"
    assert {k: tdone[k] for k in keys} == {k: jdone[k] for k in keys}
    assert tdone["admitted"] == tdone["finished"] + tdone["gave_up"]
    assert [e["ev"] for e in t[1] if e["ev"].startswith("fleet_")] == \
        [e["ev"] for e in j[1] if e["ev"].startswith("fleet_")]
    assert sorted(t[2]) == sorted(j[2])
    for key, dump in t[2].items():
        # the port sets no JAX_* variable: the child sees the ambient one
        assert dump["cache"] == os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                               "")
        assert dump["argv"][4:] == [
            a.replace(str(tmp_path / "j"), str(tmp_path / "t"))
            for a in j[2][key]["argv"][4:]]
    if name == "warm":
        evs = t[1]
        idx = {id(e): i for i, e in enumerate(evs)}
        admits = [e for e in evs if e["ev"] == "tenant_admit"]
        first0 = next(e for e in evs if e["ev"] == "tenant_progress"
                      and e["tenant"] == 0)
        assert idx[id(admits[1])] > idx[id(first0)]
        assert evs[0]["cache_dir"] is None


def test_child_normalization_and_procs_env(tmp_path):
    assert tsup.normalize_child(["-m", "x"]) == [sys.executable, "-m", "x"]
    assert tsup.normalize_child(["a.py", "--k"]) == [sys.executable, "a.py",
                                                     "--k"]
    assert tsup.normalize_child(["prog"]) == ["prog"]
    child = tmp_path / "rank.py"
    child.write_text(
        "import json, os, sys\n"
        "keys = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR')\n"
        "out = sys.argv[1] + '.' + os.environ['RANK']\n"
        "json.dump({k: os.environ[k] for k in keys}, open(out, 'w'))\n"
        "print('HEARTBEAT round=0', file=sys.stderr, flush=True)\n")
    rc = tsup.supervise([sys.executable, str(child), str(tmp_path / "env")],
                        events_path=str(tmp_path / "ev.jsonl"), procs=2,
                        out=open(os.devnull, "w"))
    assert rc == 0
    for r in (0, 1):
        env = json.loads((tmp_path / f"env.{r}").read_text())
        assert env == {"RANK": str(r), "WORLD_SIZE": "2",
                       "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1"}


LINES = ["HEARTBEAT round=7", "HEARTBEAT round=3 epoch=1 loss=2.5",
         "HEARTBEAT round=4 loss=nan guard=TRIP buf=2 stale=5",
         "HEARTBEAT round=9 loss=1.25 population=117",
         "HEARTBEAT round=12 serve_lag=3", "not a heartbeat",
         "  HEARTBEAT round=1 guard=ok population=0 serve_lag=0  "]


@pytest.mark.parametrize("line", LINES)
def test_parse_heartbeat_matches_jax(line):
    t, j = tprof.parse_heartbeat(line), jprof.parse_heartbeat(line)
    if j is not None and "loss" in j and np.isnan(j["loss"]):
        assert np.isnan(t.pop("loss")) and np.isnan(j.pop("loss"))
    assert t == j


def test_heartbeat_lines_cross_packages(capsys):
    kw = dict(epoch=2, loss=0.123456789, guard_ok=True, buffer=1, stale=4,
              population=88, serve_lag=2)
    tprof.Heartbeat(enabled=True).round(5, **kw)
    jprof.Heartbeat(enabled=True).round(5, **kw)
    t_line, j_line = capsys.readouterr().err.splitlines()
    assert t_line == j_line
    assert jprof.parse_heartbeat(t_line) == tprof.parse_heartbeat(j_line)
    assert tprof.parse_heartbeat(t_line)["population"] == 88


def test_crash_matrix_kill_resume_bit_exact(tmp_path, monkeypatch):
    """The replicated leg at the tiny CPU size: an uninterrupted run, a
    SIGKILL at a seeded round, ``--resume auto``, bit-identical weights."""
    # the children's torch on one thread: the suite runs its files in
    # parallel processes on the host's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tcm.run_matrix(str(tmp_path), trials=1, seed=0, planes=("replicated",),
                   device="cpu")
    assert os.path.exists(tmp_path / "replicated_t0" / "ResNet9.npz")


def test_crash_matrix_signals_the_supervised_child(tmp_path):
    """``run_supervised`` finds the child's pid in the supervisor's
    ``launch attempt=N pid(s)=[P]`` line and SIGKILLs it at the round;
    the supervisor relaunches it (the JAX package's copy looks for
    ``pid=P`` and never sends its fault). A fake child stands in for
    ``cv_train``."""
    import signal

    (tmp_path / "child.py").write_text(_CHILD)
    (tmp_path / "plan.json").write_text(json.dumps(
        [{"beats": 50, "beat_sleep": 0.05, "rc": 0},
         {"beats": 2, "rc": 0}]))
    events = str(tmp_path / "ev.jsonl")
    rc, sent = tcm.run_supervised(
        [sys.executable, str(tmp_path / "child.py"),
         str(tmp_path / "plan.json"), str(tmp_path / "state")], events,
        kill_round=3, kill_signal=signal.SIGKILL, timeout=120)
    assert rc == 0 and sent
    exits = [e for e in _events(events) if e["ev"] == "supervisor_child_exit"]
    assert [e["rc"] for e in exits] == [-9, 0]
    assert json.loads((tmp_path / "state.attempt1").read_text())[
        "argv"][-2:] == ["--resume", "auto"]


def test_serve_client_mode(tmp_path):
    from tests.test_torch_service import write_state

    write_state(str(tmp_path / "ck"), 3, seed=0)
    env = dict(os.environ, PYTHONPATH=ROOT)
    rep = subprocess.Popen(
        [sys.executable, "-m", "commefficient_torch.scripts.serve",
         "--checkpoint_path", str(tmp_path / "ck"), "--serve_dir",
         str(tmp_path / "sv"), "--max_requests", "1", "--poll_interval",
         "0.05", "--deadline_s", "60"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cli = subprocess.run(
        [sys.executable, "-m", "commefficient_torch.scripts.serve",
         "--serve_dir", str(tmp_path / "sv"), "--request", "stat"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    out, err = rep.communicate(timeout=120)
    assert cli.returncode == 0, cli.stderr
    resp = json.loads(cli.stdout.strip().splitlines()[-1])
    assert resp["model_version"] == 3 and resp["dim"] == 64
    assert "serving done: answered=1" in out
    assert "serve_lag=0" in err
    assert not os.path.exists(tmp_path / "ck" / "serve_"
                              f"{rep.pid}.pin")
