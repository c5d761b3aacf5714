"""The open-world service in the port (``--churn``, the serving replica
and its pin lease) against the JAX package's on the CPU, with the same
seeded inputs on both sides.

- The churn grammar: every spec and rejection of JAX's
  ``TestChurnGrammar`` gives the same ``spec()`` or the same exception
  type in both packages.
- ``PopulationManager``: the same schedule over 200 churn rounds gives
  the same events, masks and audits; a ``state_payload`` taken from
  either package mid-trajectory restores into the other's manager, which
  continues the same trajectory. With a ``RowDirectory`` on a
  ``MemmapRowStore``, retirements, flushes, reuse of holes and
  compactions leave the same directory JSON, row-file bytes and CRC
  sidecar as JAX's.
- The sampler under churn, with ``--participation`` and an idle spin,
  draws JAX's cohorts and ``cohort_short`` records; the loader's pad id
  is a live member under churn and 0 without it.
- Run states: ``pop/*`` saved by either package restores in the other;
  pruning against ``*.pin`` leases (a torn one included) keeps JAX's
  files.
- Serving: ``SnapshotTracker`` and ``ServingReplica`` against JAX's on
  crafted checksummed run states (swaps, versions, ``lag()``, ``stat`` /
  ``query`` answers, the query's float exactly, the torn candidate
  skipped, the lease written before the read and released on close),
  the port's ``serving.jsonl`` through ``scripts/obs_report.py``, and
  each package's replica serving the other's run state.
- End to end: a tiny ``cv_train`` on the disk tier under ``--churn
  join=1,depart=0.7,init=0.6,seed=3,compact=4`` (16 clients, W = 4, 2
  epochs) in both packages from the same initial weights: cohorts, churn
  events, the audit, the final directory, each round's top-k threshold
  and kept set bit for bit; weights and losses within ``rtol=1e-4,
  atol=1e-6`` (the client gradients come from another framework's
  convolutions, as in ``tests/test_torch_rounds.py``). A resume from a
  run state after a compaction is bit-identical to the continuous port
  run, and a tiny ``gpt2_train`` under ``--churn`` ends with its audit
  ok.
"""

import importlib.util
import io
import json
import os
import shutil
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.data_utils import fed_sampler as jfs  # noqa: E402
from commefficient_tpu.data_utils.loader import FedLoader as JFedLoader  # noqa: E402
from commefficient_tpu.federated import checkpoint as jck  # noqa: E402
from commefficient_tpu.federated import host_state as jhs  # noqa: E402
from commefficient_tpu.federated import participation as jp  # noqa: E402
from commefficient_tpu.federated import serving as jsv  # noqa: E402
from commefficient_tpu.federated.rounds import ClientStates as JCS  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.data_utils import fed_sampler as tfs  # noqa: E402
from commefficient_torch.data_utils.loader import FedLoader as TFedLoader  # noqa: E402
from commefficient_torch.federated import checkpoint as tck  # noqa: E402
from commefficient_torch.federated import host_state as ths  # noqa: E402
from commefficient_torch.federated import participation as tp  # noqa: E402
from commefficient_torch.federated import serving as tsv  # noqa: E402
from commefficient_torch.federated.rounds import ClientStates as TCS  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

import importlib  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "join=1,depart=0.7,init=0.6,seed=3,compact=4"
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread while this module runs:
    the suite runs its files in parallel processes on the host's cores,
    where a team of a thread a core spends its time at barriers (as in
    ``tests/test_torch_offload.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obs_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(ROOT, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the grammar -------------------------------------------------------------

GOOD = ["join=1,depart=0.7,init=0.6,seed=3,compact=4", "join=2",
        "depart=1", " join=0.5 , init=0.25 ,", "init=0.5,seed=9"]
BAD = ["join", "frobnicate=1", "init=1.5", "depart=-1", "init=1",
       "init=0,depart=1", "0.1", "seed=x,join=1", "compact=-1,join=1"]


@pytest.mark.parametrize("spec", GOOD + BAD)
def test_churn_grammar_matches_jax(spec):
    def parse(pkg):
        try:
            return pkg.parse_churn(spec).spec()
        except (ValueError, AssertionError) as e:
            return type(e)

    assert parse(tp) == parse(jp)
    if spec in GOOD:
        assert tp.parse_churn(tp.parse_churn(spec).spec()) == \
            tp.parse_churn(spec)
    assert not tp.ChurnSchedule().active


# -- the population manager --------------------------------------------------


def _trajectory(pm, n, start=0):
    """``n`` churn rounds: each round's events, masks and (every 50th)
    the audit; a cohort shortfall noted every 7th round."""
    out = []
    for r in range(start, start + n):
        pm.step(idle=(r % 11 == 5))
        if r % 7 == 3:
            pm.note_cohort_short(8, 3)
        out.append((pm.pop_events(), pm.live.copy(), pm.registered.copy(),
                    pm.departed.copy(), pm.population,
                    pm.joinable().copy(),
                    pm.audit() if r % 50 == 49 else None))
    return out


def _same_trajectory(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]
        for u, v in zip(x[1:4], y[1:4]):
            np.testing.assert_array_equal(u, v)
        assert x[4] == y[4] and x[6] == y[6]
        np.testing.assert_array_equal(x[5], y[5])


@pytest.mark.parametrize("spec", [SPEC, "join=1,depart=0.5,init=0.5,seed=7",
                                  "join=0.3,init=0,seed=2",
                                  "depart=1,seed=4"])
def test_population_manager_matches_jax(spec):
    sampler = SimpleNamespace(_quarantined=np.arange(50) % 13 == 0)
    t = tp.PopulationManager(tp.parse_churn(spec), 50, sampler=sampler)
    j = jp.PopulationManager(jp.parse_churn(spec), 50, sampler=sampler)
    _same_trajectory(_trajectory(t, 200), _trajectory(j, 200))
    assert t.audit() == j.audit() and t.audit()["ok"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_population_state_crosses_packages(direction):
    src_pkg, dst_pkg = (jp, tp) if direction == "jax_to_port" else (tp, jp)
    a = src_pkg.PopulationManager(src_pkg.parse_churn(SPEC), 50)
    _trajectory(a, 60)
    arrays, meta = a.state_payload()
    b = dst_pkg.PopulationManager(dst_pkg.parse_churn(SPEC), 50)
    b.restore_state(arrays, meta)
    _same_trajectory(_trajectory(a, 140, 60), _trajectory(b, 140, 60))
    assert a.audit() == b.audit()
    # a resume under another spec warns in both packages
    c = dst_pkg.PopulationManager(dst_pkg.parse_churn("join=2,seed=3"), 50)
    with pytest.warns(UserWarning, match="spec changed"):
        c.restore_state(arrays, meta)


SHAPES = {"errors": (3, 8), "velocities": (24,)}
ROWS = 20


def _drive_directory(pkg, d):
    """A population of 20 on a row store: 30 churn rounds, each with a
    gather and scatter of up to 4 live clients (seeded deltas), a drain
    barrier every 3rd round (``flush_retired``), and a compaction when
    the holes reach the threshold; the directory JSON, the row files and
    the CRC sidecar at the end, and the snapshot's files."""
    cs, mk = ((TCS, torch.from_numpy) if pkg is ths else (JCS, jnp.asarray))
    ppkg = tp if pkg is ths else jp
    store = pkg.MemmapRowStore(str(d), ROWS, SHAPES, io_backoff_ms=0.0)
    pm = ppkg.PopulationManager(ppkg.parse_churn(
        "join=1.2,depart=0.8,init=0.5,seed=5,compact=3"), ROWS, store=store)
    rng = np.random.RandomState(11)
    reports, events = [], []
    for r in range(30):
        pm.step()
        live = np.flatnonzero(pm.live)
        ids = rng.choice(live, min(4, len(live)), replace=False) \
            if len(live) else np.array([], np.int64)
        if len(ids):
            s = store.gather(ids)
            old = {n: np.asarray(getattr(s.proxy, n)).copy()
                   if pkg is jhs else getattr(s.proxy, n).numpy().copy()
                   for n in SHAPES}
            new = {n: old[n] + rng.randn(*old[n].shape).astype(np.float32)
                   for n in SHAPES}
            store.scatter(s, cs(weights=None,
                                **{n: mk(v) for n, v in old.items()}),
                          cs(weights=None,
                             **{n: mk(v) for n, v in new.items()}))
        if r % 3 == 2:
            store.drain()
            store.flush_retired()
            reports.append(store.maybe_compact())
        store.drain()
        events.extend(store.pop_events())
    meta = store.save_snapshot(str(d / "snap"))
    out = {"dir": json.dumps(pm.directory.state(), sort_keys=True),
           "reports": reports, "events": events,
           "files": {n: open(store.member_path(n), "rb").read()
                     for n in SHAPES},
           "crc": {n: store._crc[n].copy() for n in SHAPES},
           "meta": meta, "audit": pm.audit(),
           "snap": {f: open(d / "snap" / f, "rb").read()
                    for f in sorted(os.listdir(d / "snap"))}}
    store.close()
    return out


def test_row_directory_on_store_matches_jax(tmp_path):
    t = _drive_directory(ths, tmp_path / "t")
    j = _drive_directory(jhs, tmp_path / "j")
    assert t["dir"] == j["dir"]
    assert t["reports"] == j["reports"]
    assert any(r is not None for r in j["reports"]), "no compaction"
    assert t["events"] == j["events"]
    assert any(e["kind"] == "rows_retired" for e in j["events"])
    assert t["files"] == j["files"]
    for n in SHAPES:
        np.testing.assert_array_equal(t["crc"][n], j["crc"][n])
    assert t["meta"] == j["meta"] and t["snap"] == j["snap"]
    assert t["audit"] == j["audit"] and t["audit"]["compactions"] > 0


# -- the sampler and the loader ------------------------------------------------


def _cohorts(pkg, ppkg, spec, participation):
    ds = SimpleNamespace(num_clients=24,
                         data_per_client=np.arange(24) % 5 + 1)
    np.random.seed(3)
    s = pkg.FedSampler(ds, 6, 2, participation=participation)
    pm = ppkg.PopulationManager(ppkg.parse_churn(spec), 24, sampler=s)
    s._population = pm
    out = []
    for _ in range(2):
        for workers, idx in s.iter_structured():
            out.append((workers.tolist(), [i.tolist() for i in idx],
                        pm.pop_events()))
    return out, pm.audit(), np.random.randint(1 << 30)


@pytest.mark.parametrize("spec,participation", [
    ("join=1,depart=0.7,init=0.6,seed=3", 4),
    ("join=0.05,init=0.1,depart=2,seed=1", None),
    ("join=0.5,init=0,seed=8", 3)])
def test_sampler_under_churn_matches_jax(spec, participation):
    t = _cohorts(tfs, tp, spec, participation)
    j = _cohorts(jfs, jp, spec, participation)
    assert t == j
    kinds = [e["kind"] for _, _, evs in j[0] for e in evs]
    assert "churn_join" in kinds
    if participation == 4:
        assert "cohort_short" in kinds
    if spec.startswith("join=0.05"):
        assert j[1]["idle_rounds"] > 0  # the pool emptied and refilled


def test_idle_spin_is_bounded():
    ds = SimpleNamespace(num_clients=4, data_per_client=np.ones(4, int))
    s = tfs.FedSampler(ds, 2, 1)
    pm = tp.PopulationManager(tp.parse_churn("join=0.5,init=0,seed=0"), 4,
                              sampler=s)
    pm.MAX_IDLE_SPIN = 0
    s._population = pm
    pm.rng = SimpleNamespace(poisson=lambda lam: 0)  # nobody ever joins
    with pytest.raises(RuntimeError, match="stayed empty"):
        next(s.iter_structured())


def test_loader_pad_id_open_vs_closed_world():
    workers = np.array([7, 3], np.int64)
    for loader in (TFedLoader, JFedLoader):
        closed = SimpleNamespace(sampler=SimpleNamespace(_population=None))
        churned = SimpleNamespace(sampler=SimpleNamespace(
            _population=object()))
        assert loader._pad_id(closed, workers) == 0
        assert loader._pad_id(churned, workers) == 7
        assert loader._pad_id(churned, np.array([], np.int64)) == 0


# -- pruning and the pin lease -----------------------------------------------


def write_state(ckpt_dir, rounds, seed, d=64, epoch=1):
    """A checksummed run state as ``save_run_state`` lays it out (the
    serving subset: the flat ``ps_weights`` and the meta)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    w = np.random.RandomState(seed).standard_normal(d).astype(np.float32)
    meta = {"checksum": tck._content_checksum({"ps_weights": w}),
            "rounds_dispatched": rounds}
    path = os.path.join(ckpt_dir, f"run_state_ep{epoch}_r{rounds}.npz")
    np.savez(path, ps_weights=w,
             meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    return path, w


def _lease_dir(d):
    for r in (3, 6, 9, 12, 15):
        write_state(str(d), r, seed=r)
    os.makedirs(d / "run_state_ep1_r6.rows")
    with open(d / "serve.pin", "w") as f:
        json.dump({"owner": "serve", "pid": 1,
                   "paths": ["run_state_ep1_r6.npz"]}, f)
    with open(d / "abs.pin", "w") as f:
        json.dump({"owner": "abs", "paths": [
            str(d / "run_state_ep1_r3.npz")]}, f)
    with open(d / "torn.pin", "w") as f:
        f.write('{"owner": "torn", "paths": ["run_state_ep1_r9.npz"')


@pytest.mark.parametrize("keep", [0, 1, 2, 4])
def test_prune_respects_leases_as_jax(tmp_path, capsys, keep):
    _lease_dir(tmp_path / "t")
    _lease_dir(tmp_path / "j")
    assert {os.path.basename(p) for p in
            tck.pinned_run_states(str(tmp_path / "t"))} == \
        {os.path.basename(p) for p in
         jck.pinned_run_states(str(tmp_path / "j"))} == \
        {"run_state_ep1_r3.npz", "run_state_ep1_r6.npz"}
    tck.prune_run_states(str(tmp_path / "t"), keep)
    jck.prune_run_states(str(tmp_path / "j"), keep)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    out = capsys.readouterr().out
    assert "unreadable pin" in out
    if keep:
        assert "keeping pinned run state" in out
        # the torn lease protects nothing: r9 goes once keep < 3
        assert os.path.exists(tmp_path / "t" / "run_state_ep1_r9.npz") \
            == (keep >= 3)


# -- serving -----------------------------------------------------------------


def _tracker_story(pkg, ckpt):
    tr = pkg.SnapshotTracker(ckpt, owner="t")
    story = [(tr.poll(), tr.version, tr.swaps, tr.lag())]
    write_state(ckpt, 3, seed=0)
    story.append((tr.poll(), tr.version, tr.swaps, tr.lag()))
    with open(os.path.join(ckpt, "t.pin")) as f:
        lease = json.load(f)
    story.append(lease["paths"])
    write_state(ckpt, 6, seed=1)
    write_state(ckpt, 9, seed=2)
    story.append(tr.lag())
    story.append((tr.poll(), tr.version, tr.swaps, tr.lag()))
    # a newer candidate with a lying checksum is skipped
    path, _ = write_state(ckpt, 12, seed=3)
    with np.load(path) as z:
        flat = dict(z)
    meta = json.loads(bytes(flat["meta_json"]).decode())
    meta["checksum"] ^= 0xDEAD
    flat["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **flat)
    story.append((tr.poll(), tr.version, tr.swaps, tr.lag()))
    story.append(tr.weights.tobytes())
    tr.release()
    story.append(os.path.exists(os.path.join(ckpt, "t.pin")))
    return story


def test_snapshot_tracker_matches_jax(tmp_path, capsys):
    t = _tracker_story(tsv, str(tmp_path / "t"))
    j = _tracker_story(jsv, str(tmp_path / "j"))
    assert t == j
    assert t[1] == (True, 3, 1, 0) and t[-3] == (False, 9, 2, 1)
    assert t[-1] is False
    assert capsys.readouterr().out.count("skipping") == 2


def test_lease_written_before_the_read(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    path, _ = write_state(ckpt, 3, seed=0)
    seen = []
    read = tck._read_npz

    def spy(p):
        with open(os.path.join(ckpt, "me.pin")) as f:
            seen.append(json.load(f)["paths"])
        return read(p)

    tr = tsv.SnapshotTracker(ckpt, owner="me")
    with mock.patch.object(tck, "_read_npz", spy):
        assert tr.poll()
    assert seen == [[os.path.basename(path)]]
    tr.release()


def _replica_answers(pkg, tmp, ckpt):
    serve = str(tmp / "serve")
    rep = pkg.ServingReplica(ckpt, serve, owner="r")
    answers = []

    def ask(op, **kw):
        rid = pkg.submit_request(serve, op=op, **kw)
        rep.step()
        resp = pkg.read_response(serve, rid, timeout=5, poll=0.01)
        resp.pop("id")
        resp.pop("latency_ms")
        answers.append(resp)

    ask("query", probe_seed=0)
    write_state(ckpt, 3, seed=0, d=1000)
    for seed in (5, 6):
        ask("query", probe_seed=seed)
    ask("stat")
    write_state(ckpt, 6, seed=1, d=1000)
    ask("stat")
    ask("query", probe_seed=5)
    ask("ping")
    ask("eval")
    ask("frobnicate")
    rep.close()
    return answers, rep.answered, rep.errors, rep.tracker.swaps, serve


def test_serving_replica_matches_jax(tmp_path):
    t = _replica_answers(tsv, tmp_path / "t", str(tmp_path / "t" / "ck"))
    j = _replica_answers(jsv, tmp_path / "j", str(tmp_path / "j" / "ck"))
    # eval's message names each package's own script
    assert "predict_fn" in t[0][-2]["error"]
    t[0][-2].pop("error"), j[0][-2].pop("error")
    assert t[0] == j[0] and t[1:4] == j[1:4]
    assert t[0][1]["value"] != t[0][5]["value"]  # the swap shows
    assert t[0][0]["model_version"] == -1 and "error" in t[0][0]
    # the port's log renders through the JAX package's report
    obs = _obs_report()
    sv = obs.summarize(obs.load_events(
        os.path.join(t[4], "serving.jsonl")))["serving"]
    assert sv["answers"] == 9 and sv["errors"] == 3
    assert sv["swaps"] == 2 and sv["swap_versions"] == [3, 6]
    assert sv["versions_monotone"] and sv["clean_stop"]
    assert sv["final_version"] == 6
    buf = io.StringIO()
    obs.render(obs.load_events(os.path.join(t[4], "serving.jsonl")),
               out=buf)
    assert "Serving" in buf.getvalue()


def test_replica_never_initializes_cuda(tmp_path):
    """The replica is host numpy: a process that serves a query has not
    initialized CUDA."""
    import subprocess

    write_state(str(tmp_path / "ck"), 3, seed=0)
    code = (
        "import sys, torch\n"
        "from commefficient_torch.federated import serving as s\n"
        f"r = s.ServingReplica({str(tmp_path / 'ck')!r}, "
        f"{str(tmp_path / 'sv')!r})\n"
        f"rid = s.submit_request({str(tmp_path / 'sv')!r}, op='query')\n"
        "r.step(); r.close()\n"
        "sys.exit(1 if torch.cuda.is_initialized() else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- end to end --------------------------------------------------------------


def _cv_argv(tmp, pkg_tag, extra=()):
    return ["--device", "cpu", "--dataset_name", "CIFAR10", "--dataset_dir",
            str(tmp / f"data_{pkg_tag}"), "--num_epochs", "2",
            "--num_workers", "4", "--local_batch_size", "4", "--iid",
            "--num_clients", "16", "--mode", "sketch", "--error_type",
            "local", "--local_momentum", "0.9", "--virtual_momentum", "0",
            "--k", "200", "--num_cols", "1024", "--num_rows", "3",
            "--num_blocks", "2", "--lr_scale", "0.01", "--pivot_epoch",
            "0.5", "--seed", "0", "--train_dataloader_workers", "0",
            "--churn", SPEC, "--checkpoint", "--checkpoint_path",
            str(tmp / f"ck_{pkg_tag}"), "--checkpoint_every_rounds", "3",
            "--state_dir", str(tmp / f"state_{pkg_tag}"),
            *extra]


def _recording(base, rec):
    """``base`` (a package's ``FedModel``) recording its instances and each
    round's cohort and gradient table. The JAX model records its initial
    flat weights; the port's model starts from them."""

    class Recording(base):
        def __init__(self, *a, **k):
            if "flat0" in rec:
                k["init_params"] = flat_from_jax(rec["flat0"],
                                                 ParamLayout(a[0]))
            super().__init__(*a, **k)
            if "flat0" not in rec:
                rec["flat0"] = np.asarray(ravel_pytree(self.params)[0])
            rec["models"].append(self)

        def begin_round(self, batch):
            h = super().begin_round(batch)
            g = self._round_ctx.gradient
            rec["rounds"].append((
                np.asarray(batch["client_ids"]).tolist(),
                np.asarray(batch["worker_mask"]).tolist(),
                g.numpy().copy() if isinstance(g, torch.Tensor)
                else np.asarray(g).copy()))
            return h

    return Recording


def _events(run_dir):
    keep = ("churn_join", "churn_depart", "cohort_short", "rows_retired",
            "rows_compacted", "churn_audit")
    out = []
    with open(os.path.join(run_dir, "telemetry.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            if e["ev"] in keep:
                e.pop("t")
                out.append(e)
    return out


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("service_e2e")
    env = {"COMMEFFICIENT_TINY_MODEL": "1",
           "COMMEFFICIENT_SYNTHETIC_PER_CLASS": "8",
           "COMMEFFICIENT_STATE_HBM_BUDGET": "1",
           "COMMEFFICIENT_STATE_HOST_BUDGET": "1"}
    sys.path.insert(0, ROOT)
    import cv_train as j_cv  # the JAX package's entry point

    from commefficient_torch import cv_train as t_cv

    out = {"tmp": tmp}
    jrec = {"models": [], "rounds": []}
    with mock.patch.dict(os.environ, dict(
            env, COMMEFFICIENT_RUN_DIR=str(tmp / "run_j"))), \
            mock.patch.object(j_cv, "FedModel",
                              _recording(j_cv.FedModel, jrec)):
        out["j_summary"] = j_cv.main(_cv_argv(tmp, "j"))
    jfm = jrec["models"][0]
    out["jrec"] = jrec
    out["j_dir"] = jfm._row_store.directory.state()
    out["j_sketch"] = jfm.sketch
    out["j_events"] = _events(tmp / "run_j")
    trec = {"models": [], "rounds": [], "flat0": jrec["flat0"]}
    with mock.patch.dict(os.environ, dict(
            env, COMMEFFICIENT_RUN_DIR=str(tmp / "run_t"))), \
            mock.patch.object(t_cv, "FedModel",
                              _recording(t_cv.FedModel, trec)):
        out["t_summary"] = t_cv.main(_cv_argv(tmp, "t"))
        tfm = trec["models"][0]
        out["t_rounds"] = list(trec["rounds"])
        out["t_dir"] = tfm._row_store.directory.state()
        out["t_sketch"] = tfm.sketch
        out["t_events"] = _events(tmp / "run_t")
        # resume from a run state after the first compaction
        res = tmp / "res"
        res.mkdir()
        name = "run_state_ep1_r6"
        shutil.copy(tmp / "ck_t" / (name + ".npz"), res)
        shutil.copytree(tmp / "ck_t" / (name + ".rows"),
                        res / (name + ".rows"))
        argv = _cv_argv(tmp, "t", ["--resume", "auto"])
        argv[argv.index(str(tmp / "ck_t"))] = str(res)
        argv[argv.index(str(tmp / "state_t"))] = str(tmp / "state_r")
        out["r_summary"] = t_cv.main(argv)
        out["r_meta"] = json.loads(bytes(np.load(
            res / (name + ".npz"))["meta_json"]).decode())
    return out


def test_e2e_churn_matches_jax(e2e):
    jr, tr = e2e["jrec"]["rounds"], e2e["t_rounds"]
    assert len(jr) == 9
    assert [r[:2] for r in tr] == [r[:2] for r in jr]  # cohorts
    assert e2e["t_events"] == e2e["j_events"]
    kinds = [e["ev"] for e in e2e["j_events"]]
    assert "rows_compacted" in kinds and "rows_retired" in kinds
    audit = [e for e in e2e["t_events"] if e["ev"] == "churn_audit"]
    assert len(audit) == 1 and audit[0]["ok"]
    assert e2e["t_dir"] == e2e["j_dir"]
    for r, ((_, _, jg), (_, _, tg)) in enumerate(zip(jr, tr)):
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL,
                                   err_msg=f"round {r} table")
        # from JAX's table, each package's query, threshold and kept set
        test_ = tsk.estimates_chunks(e2e["t_sketch"], torch.from_numpy(jg))
        jest = jsk.estimates_chunks(e2e["j_sketch"], jnp.asarray(jg))
        np.testing.assert_array_equal(test_.numpy(), np.asarray(jest))
        assert int(ttk.resolve_threshold(test_, 200)) == \
            int(jtk.resolve_threshold(jest, 200)), r
        tupd = tsk.unsketch_chunks(e2e["t_sketch"], torch.from_numpy(jg),
                                   200).numpy()
        jupd = np.asarray(jsk.unsketch_chunks(e2e["j_sketch"],
                                              jnp.asarray(jg), 200))
        np.testing.assert_array_equal(np.flatnonzero(tupd),
                                      np.flatnonzero(jupd), err_msg=str(r))
    a = np.load(e2e["tmp"] / "ck_t" / "ResNet9.npz")
    b = np.load(e2e["tmp"] / "ck_j" / "ResNet9.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(e2e["t_summary"][k], e2e["j_summary"][k],
                                   rtol=RTOL, atol=ATOL)


def test_e2e_mid_churn_resume_bit_exact(e2e):
    assert e2e["r_meta"]["client_store"]["directory"]["compactions"] > 0
    a = np.load(e2e["tmp"] / "ck_t" / "ResNet9.npz")
    b = np.load(e2e["tmp"] / "res" / "ResNet9.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("train_loss", "train_acc", "test_loss", "test_acc"):
        assert e2e["t_summary"][k] == e2e["r_summary"][k], k


def test_run_states_cross_packages(e2e, tmp_path):
    """A JAX run state with ``pop/*`` and a ``.rows`` directory restores
    the port's manager and store; the port's restores JAX's (through
    JAX's discovery, manager and store: JAX's ``load_run_state`` needs
    its ``rng`` key, which a port run state does not carry)."""
    tmp = e2e["tmp"]
    name = "run_state_ep1_r6"
    for src, pkg, ppkg in (("ck_j", ths, tp), ("ck_t", jhs, jp)):
        ck = str(tmp / src)
        found = (jck if pkg is jhs else tck).find_resume_checkpoint(
            ck, return_contents=True)
        assert found is not None
        flat = dict(np.load(os.path.join(ck, name + ".npz")))
        meta = json.loads(bytes(flat.pop("meta_json")).decode())
        pop = {k[4:]: v for k, v in flat.items() if k.startswith("pop/")}
        assert sorted(pop) == ["departed", "live", "pending_join",
                               "registered", "rng_cached", "rng_keys",
                               "rng_meta"]
        store_meta = meta["client_store"]
        shapes = {n: tuple(m["shape"])
                  for n, m in store_meta["members"].items()}
        store = pkg.MemmapRowStore(str(tmp_path / src), 16, shapes)
        pm = ppkg.PopulationManager(ppkg.parse_churn(SPEC), 16,
                                    store=store)
        store.restore_snapshot(os.path.join(ck, store_meta["dir"]),
                               store_meta)
        pm.restore_state(pop, meta["population"])
        assert pm.directory.state() == store_meta["directory"]
        other = pkg is jhs
        twin = (jp if other else tp).PopulationManager(
            (jp if other else tp).parse_churn(SPEC), 16)
        twin.restore_state(pop, meta["population"])
        _same_trajectory(_trajectory(pm, 20), _trajectory(twin, 20))
        for n in shapes:
            np.testing.assert_array_equal(
                store.read_full(n),
                (ths if other else jhs).read_snapshot_member(
                    os.path.join(ck, store_meta["dir"]), store_meta, n))
        store.close()


def test_replicas_serve_the_other_package(e2e, tmp_path):
    """Each package's replica serves the other's run states with the same
    answers."""
    for src in ("ck_j", "ck_t"):
        ck = str(tmp_path / src)
        shutil.copytree(e2e["tmp"] / src, ck,
                        ignore=shutil.ignore_patterns("*.rows", "state*"))
        got = []
        for pkg in (tsv, jsv):
            tr = pkg.SnapshotTracker(ck, owner=pkg.__name__)
            assert tr.poll()
            got.append((tr.version, tr.weights.tobytes()))
            tr.release()
        assert got[0] == got[1] and got[0][0] > 0


def test_gpt2_train_under_churn(tmp_path, monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
    monkeypatch.setenv("COMMEFFICIENT_RUN_DIR", str(tmp_path / "run"))
    from commefficient_torch import gpt2_train

    gpt2_train.train([
        "--device", "cpu", "--dataset_dir", str(tmp_path / "persona"),
        "--num_epochs", "1", "--num_workers", "2", "--local_batch_size",
        "2", "--max_seq_len", "64", "--mode", "sketch", "--error_type",
        "virtual", "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", "5000", "--num_cols", "20000", "--num_rows", "3",
        "--num_blocks", "2", "--seed", "0", "--churn",
        "join=1,depart=0.5,init=0.5,seed=2"])
    evs = _events(tmp_path / "run")
    audit = [e for e in evs if e["ev"] == "churn_audit"]
    assert len(audit) == 1 and audit[0]["ok"]
    assert any(e["ev"] == "churn_depart" for e in evs)
