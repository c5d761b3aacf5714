"""Per-client state off the card, end to end: the port's streamed rounds
(``FedModel`` in the ``host`` and ``disk`` tiers, forced with the JAX
package's budget overrides) against the JAX package's streamed rounds on
the CPU, with a tiny ResNet9, 12 clients and W = 4 slots.

- Sketch-local (``--mode sketch --error_type local --local_momentum 0.9
  --virtual_momentum 0``) and local top-k (``--mode local_topk
  --error_type local --local_momentum 0.9``), 5 rounds with a repeated
  client, a padded slot and a short client, synchronous and (sketch)
  under ``--participation 0.75 --inject_client_fault``: from JAX's round
  table each round the threshold and the kept set bit for bit (each
  package running its own query and threshold; for local top-k the
  transmit's support); the port's own tables, weights and final client
  rows within ``rtol=1e-4, atol=1e-6`` (``tests/test_torch_rounds.py``'s
  tolerance: the client gradients come from another framework's
  convolutions), and the cohort records and counters of the
  participation run exactly.
- Within the port, bit for bit: ``hbm``, ``host`` and ``disk``, each
  with prefetch on (``engine.cohort_lookahead``) and off
  (``COMMEFFICIENT_COHORT_PREFETCH=0``), give the same weights and rows;
  the disk tier under ``--inject_io_fault eio=0.02,short=0.01,torn=0.01``
  too.
- The run state: a mid-epoch ``--resume auto`` of ``cv_train`` on the
  disk tier is bit-exact (final weights and summary), with
  ``--keep_checkpoints`` pruning the ``.rows`` beside each pruned file;
  a JAX disk-tier run state (``.npz`` + ``.rows/`` + ``io/*``) restores
  into the port's disk tier (and, lifted, into its ``hbm`` tier) with
  JAX's rows, injector stream and participation state; a port disk-tier
  run state passes JAX's ``find_resume_checkpoint`` and its ``.rows``
  restores in JAX's ``MemmapRowStore``.
- The ``offload`` span: its keys and tier / prefetch values equal
  JAX's; ``scripts/obs_report.py`` (unedited, in a subprocess) renders
  the "Host offload" section of a port ``cv_train`` log whose flip drill
  with ``--io_scrub_rows`` fires the ``io_corrupt`` watch rule.
- Two ``gloo`` ranks (``tests/torch_dist_ranks.body_offload``), host and
  disk tiers, replicated and ``--server_shard``: each rank keeps its own
  rows (``<state_dir>/rank<r>``), the ranks agree bit for bit, and the
  weights and rows match JAX's single-process streamed round within the
  tolerance above.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated import LambdaLR as JLambdaLR  # noqa: E402
from commefficient_tpu.federated import checkpoint as jck  # noqa: E402
from commefficient_tpu.federated import host_state as jhs  # noqa: E402
from commefficient_tpu.federated import participation as jp  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR  # noqa: E402
from commefficient_torch.federated import PipelinedRoundEngine  # noqa: E402
from commefficient_torch.federated import checkpoint as tck  # noqa: E402
from commefficient_torch.federated import cohort_lookahead  # noqa: E402
from commefficient_torch.federated import participation as tp  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402
from tests.torch_dist_ranks import TINY, start_ranks  # noqa: E402

import importlib  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, B, NCLIENTS, K, ROUNDS = 4, 4, 12, 500, 5
SKETCH_LOCAL = ["--mode", "sketch", "--error_type", "local",
                "--local_momentum", "0.9", "--virtual_momentum", "0",
                "--k", str(K), "--num_cols", "2048", "--num_rows", "3",
                "--num_blocks", "2"]
LOCAL_TOPK = ["--mode", "local_topk", "--error_type", "local",
              "--local_momentum", "0.9", "--virtual_momentum", "0",
              "--k", str(K)]
COMMON = ["--num_workers", str(W), "--num_devices", "1",
          "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
          "--local_batch_size", str(B), "--seed", "0"]
PART = ["--participation", "0.75", "--inject_client_fault",
        "drop=0.1,slow=0.3,corrupt=0.1,delay=2,seed=3"]
IO_FAULT = ["--inject_io_fault", "eio=0.02,short=0.01,torn=0.01,seed=3"]
CONFIGS = {"sketch": SKETCH_LOCAL + COMMON,
           "local_topk": LOCAL_TOPK + COMMON,
           "participation": SKETCH_LOCAL + COMMON + PART}
TIERS = {"hbm": {},
         "host": {"COMMEFFICIENT_STATE_HBM_BUDGET": "1"},
         "disk": {"COMMEFFICIENT_STATE_HBM_BUDGET": "1",
                  "COMMEFFICIENT_STATE_HOST_BUDGET": "1"}}
RTOL, ATOL = 1e-4, 1e-6
MEMBERS = ("velocities", "errors")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread while this module runs:
    the suite runs 6 test processes on the host's cores at once, where
    each process's default team of a thread a core spends its time
    waiting at barriers. Every comparison here is between runs made under
    this setting, or against JAX within the stated tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _env(**env):
    keys = set(env) | {"COMMEFFICIENT_STATE_HBM_BUDGET",
                       "COMMEFFICIENT_STATE_HOST_BUDGET",
                       "COMMEFFICIENT_COHORT_PREFETCH"}
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _batch(rnd):
    """4 slots; client 3 comes back every round (its rows are re-read
    after its own scatter), slot 3 is padding in rounds 1 and 3, a short
    client in round 2."""
    rng = np.random.RandomState(300 + rnd)
    mask = np.ones((W, B), np.float32)
    wmask = np.ones(W, np.float32)
    ids = rng.choice([c for c in range(NCLIENTS) if c != 3], W,
                     replace=False).astype(np.int32)
    ids[0] = 3
    if rnd in (1, 3):
        mask[W - 1] = 0.0
        wmask[W - 1] = 0.0
        ids[W - 1] = 0
    if rnd == 2:
        mask[1, 3] = 0.0
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": mask, "client_ids": ids, "worker_mask": wmask}


def _lam(step):
    # constant, as the dist leg's ranks set it: its 3 rounds are the
    # first 3 of the single-process sketch run
    return 0.1


def _jax(argv, tier, state_dir):
    with _env(**TIERS[tier]):
        jargs = j_parse(argv=argv + ["--no_telemetry", "--state_dir",
                                     str(state_dir)])
        jm = JResNet9(channels=TINY)
        jtrain, jval = j_losses(jm)
        jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                        num_clients=NCLIENTS)
    assert jfm.memory_plan.placement == tier
    jopt = JFedOptimizer(jfm, jargs)
    jsched = JLambdaLR(jopt, _lam)
    ctl = jp.attach_participation(jargs, jfm)
    return jfm, jopt, jsched, ctl


def _port(flat0, argv, tier, state_dir, prefetch=True):
    with _env(COMMEFFICIENT_COHORT_PREFETCH=None if prefetch else "0",
              **TIERS[tier]):
        args = t_parse(argv=argv + ["--device", "cpu", "--no_telemetry",
                                    "--state_dir", str(state_dir)])
        tm = ResNet9(channels=TINY)
        train, val = t_losses(tm)
        fm = FedModel(tm, train, args, val, num_clients=NCLIENTS,
                      init_params=flat_from_jax(flat0, ParamLayout(tm)),
                      device="cpu")
    assert fm.memory_plan.placement == tier
    opt = FedOptimizer(fm, args)
    sched = LambdaLR(opt, _lam)
    return fm, opt, sched, tp.attach_participation(args, fm)


def _jrows(jfm):
    st = jfm._row_store
    if st is not None:
        return {m: st.read_full(m) for m in st.row_shapes}
    return {m: np.array(getattr(jfm.client_states, m)) for m in MEMBERS}


def _trows(fm):
    fm.drain_client_state()
    st = fm._row_store
    if st is not None:
        return {m: st.read_full(m) for m in st.row_shapes}
    return {m: getattr(fm.client_states, m).numpy().copy() for m in MEMBERS}


def _jround(jfm, jopt, jsched, batch):
    jsched.step()
    h = jfm.begin_round(batch)
    g = np.asarray(jfm._round_ctx.gradient).copy()
    jopt.step()
    off = dict(jfm._pending_offload or {})
    jfm.finish_round(h)
    return g, np.asarray(ravel_pytree(jfm.params)[0]), h.cohort, off


def _tround(fm, opt, sched, batch):
    sched.step()
    h = fm.begin_round(batch)
    g = fm._round_ctx.gradient.numpy().copy()
    opt.step()
    h = fm.seal_round(h)
    fm.finish_round(h)
    w = (fm.layout.unchunk(fm.ps_weights) if fm.layout is not None
         else fm.ps_weights).numpy().copy()
    return g, w, h.cohort, h.offload


def _engine_run(flat0, argv, tier, d, prefetch):
    """The port through the round engine and ``cohort_lookahead`` (the
    prefetcher's path): final weights, rows and prefetch counters."""
    fm, opt, sched, _ = _port(flat0, argv, tier, d, prefetch=prefetch)
    eng = PipelinedRoundEngine(fm, opt, sched, window=2, drain_every=3)
    for b in cohort_lookahead([_batch(r) for r in range(ROUNDS)], fm):
        eng.submit(b)
    eng.drain()
    out = {"w": fm.ps_weights.numpy().copy(), "rows": _trows(fm),
           "pf": fm._prefetcher.counters() if fm._prefetcher else None}
    fm.finalize()
    return out


def _dist_spec(flat0, tmp):
    runs = [(SKETCH_LOCAL + COMMON[:2] + ["--num_devices", "2"]
             + COMMON[4:], TIERS[t]) for t in ("host", "disk")]
    runs.append((runs[1][0] + ["--server_shard"], TIERS["disk"]))
    return {"runs": runs, "batches": [_batch(r) for r in range(3)],
            "flat0": flat0, "num_clients": NCLIENTS, "lr": 0.1,
            "dir": str(tmp / "dist")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("offload")
    jax_models = {
        "sketch": _jax(CONFIGS["sketch"], "host", tmp / "j_sketch"),
        "local_topk": _jax(CONFIGS["local_topk"], "host", tmp / "j_topk"),
        "participation": _jax(CONFIGS["participation"] + IO_FAULT, "disk",
                              tmp / "j_part")}
    flat0 = np.asarray(ravel_pytree(jax_models["sketch"][0].params)[0])
    out = {"tmp": tmp, "flat0": flat0}
    with start_ranks(2, [("body_offload", _dist_spec(flat0, tmp))],
                     tmp) as ranks:
        for name, (jfm, jopt, jsched, _) in jax_models.items():
            out["j_" + name] = []
            for r in range(ROUNDS):
                out["j_" + name].append(_jround(jfm, jopt, jsched,
                                                _batch(r)))
                if name == "sketch" and r == 2:
                    # the dist leg's reference: 3 rounds at lr 0.1
                    out["j_dist"] = ([x[1] for x in out["j_sketch"]],
                                     _jrows(jfm))
            out["j_" + name + "_rows"] = _jrows(jfm)
        jfm, jopt, jsched, jctl = jax_models["participation"]
        out["j_part_counters"] = jctl.counters()
        out["j_part_io"] = jfm._row_store.io_counters()
        # a JAX disk-tier run state: .npz + .rows/ + io/* + part/*
        out["j_rs"] = jck.save_run_state(
            str(tmp / "jrs" / "run_state_ep1_r5"), jfm, jopt, jsched,
            next_epoch=0, totals=(0.0, 0.0),
            mid_epoch={"rounds_done": 5, "sampler": {
                "permuted": np.arange(48, dtype=np.int64),
                "cursor": np.arange(NCLIENTS, dtype=np.int64)}})
        st = jfm._row_store.inject.rng.get_state()
        out["j_io_next"] = jfm._row_store.inject.rng.random_sample(5)
        jfm._row_store.inject.rng.set_state(st)
        out["j_sketch_obj"] = jax_models["sketch"][0].sketch
        for name in ("sketch", "local_topk", "participation"):
            for tier in ("host", "disk"):
                argv = CONFIGS[name] + (IO_FAULT if name == "participation"
                                        and tier == "disk" else [])
                fm, opt, sched, ctl = _port(flat0, argv, tier,
                                            tmp / f"t_{name}_{tier}")
                out[f"t_{name}_{tier}"] = [_tround(fm, opt, sched,
                                                   _batch(r))
                                           for r in range(ROUNDS)]
                out[f"t_{name}_{tier}_rows"] = _trows(fm)
                if ctl is not None:
                    out[f"t_{name}_{tier}_counters"] = ctl.counters()
                if name == "participation" and tier == "disk":
                    out["t_sketch_obj"] = fm.sketch
                    out["t_rs"] = tck.save_run_state(
                        str(tmp / "trs" / "run_state_ep1_r5"), fm, opt,
                        sched, next_epoch=0, totals=(0.0, 0.0))
                    out["t_rs_rows"] = _trows(fm)
                fm.finalize()
        out["dist"] = ranks.join()[0]
    return out


def _check_round(name, tier, r, jx, tx, tsketch, jsketch):
    (jg, jw, jcoh, _), (tg, tw, tcoh, _) = jx, tx
    what = f"{name} {tier} round {r}"
    assert tcoh == jcoh, what
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL, err_msg=what)
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL, err_msg=what)
    if name == "local_topk":
        # the union of the clients' top-k: the transmit's support
        np.testing.assert_array_equal(np.flatnonzero(tg),
                                      np.flatnonzero(jg), err_msg=what)
        return
    # from JAX's round table: each package's query, threshold, kept set
    test_ = tsk.estimates_chunks(tsketch, torch.from_numpy(jg))
    jest = jsk.estimates_chunks(jsketch, jnp.asarray(jg))
    np.testing.assert_array_equal(test_.numpy(), np.asarray(jest))
    assert int(ttk.resolve_threshold(test_, K)) == \
        int(jtk.resolve_threshold(jest, K)), what
    tupd = tsk.unsketch_chunks(tsketch, torch.from_numpy(jg), K).numpy()
    jupd = np.asarray(jsk.unsketch_chunks(jsketch, jnp.asarray(jg), K))
    np.testing.assert_array_equal(np.flatnonzero(tupd),
                                  np.flatnonzero(jupd), err_msg=what)


@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("name", ["sketch", "local_topk", "participation"])
def test_streamed_rounds_match_jax(runs, name, tier):
    jx, tx = runs["j_" + name], runs[f"t_{name}_{tier}"]
    for r in range(ROUNDS):
        _check_round(name, tier, r, jx[r], tx[r], runs["t_sketch_obj"],
                     runs["j_sketch_obj"])
    jrows, trows = runs[f"j_{name}_rows"], runs[f"t_{name}_{tier}_rows"]
    assert sorted(jrows) == sorted(trows)
    for m in jrows:
        np.testing.assert_allclose(trows[m], jrows[m], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {tier} {m}")
        assert np.abs(trows[m]).sum() > 0
    if name == "participation":
        assert runs[f"t_{name}_{tier}_counters"] == runs["j_part_counters"]


@pytest.mark.parametrize("name", ["sketch", "local_topk", "participation"])
def test_tiers_bit_equal_prefetch_on_off(runs, name, tmp_path):
    flat0 = runs["flat0"]
    outs = {}
    for tier in ("hbm", "host", "disk"):
        # the hbm tier has no prefetcher: one run
        for pf in ((True,) if tier == "hbm" else (True, False)):
            extra = IO_FAULT if (tier == "disk" and pf) else []
            outs[(tier, pf)] = _engine_run(flat0, CONFIGS[name] + extra,
                                           tier, tmp_path / f"{tier}{pf}",
                                           pf)
    ref = outs[("hbm", True)]
    for key, o in outs.items():
        np.testing.assert_array_equal(o["w"].view(np.uint32),
                                      ref["w"].view(np.uint32),
                                      err_msg=str(key))
        for m in ref["rows"]:
            np.testing.assert_array_equal(o["rows"][m].view(np.uint32),
                                          ref["rows"][m].view(np.uint32),
                                          err_msg=f"{key} {m}")
        if key[0] != "hbm":
            pf = o["pf"]
            if key[1]:
                assert pf["hits"] == ROUNDS - 1 and pf["misses"] == 1
            else:
                assert pf["hits"] == 0 and pf["misses"] == ROUNDS
        else:
            assert o["pf"] is None


def test_offload_span_matches_jax(runs):
    """The offload record of every round: JAX's keys, tier and prefetch
    (the synchronous loop never prefetches: a miss every round)."""
    for tier, jname in (("disk", "participation"),):
        for (_, _, _, joff), (_, _, _, toff) in zip(
                runs["j_" + jname], runs[f"t_{jname}_{tier}"]):
            assert sorted(toff) == sorted(joff)
            assert (toff["tier"], toff["prefetch"]) == \
                (joff["tier"], joff["prefetch"]) == ("disk", "miss")
    toff = runs["t_sketch_host"][0][3]
    assert sorted(toff) == ["gather_ms", "prefetch", "scatter_ms", "tier"]
    assert toff["tier"] == "host"


def test_jax_rows_run_state_restores_in_port(runs, tmp_path):
    """JAX's disk-tier run state restores into the port's disk tier (rows,
    sidecar, injector stream, participation state) and into its hbm tier
    (the snapshot lifted to full arrays)."""
    path = runs["j_rs"]
    jrows = runs["j_participation_rows"]
    for tier in ("disk", "hbm"):
        argv = CONFIGS["participation"] + (IO_FAULT if tier == "disk"
                                           else [])
        fm, opt, sched, ctl = _port(runs["flat0"], argv, tier,
                                    tmp_path / tier)
        found = tck.find_resume_checkpoint(str(os.path.dirname(path)),
                                           return_contents=True)
        assert found[0] == path
        _, _, mid = tck.load_run_state(path, fm, opt, sched,
                                       preloaded=found[1])
        assert mid["rounds_done"] == 5
        rows = _trows(fm)
        for m in jrows:
            np.testing.assert_array_equal(rows[m], jrows[m])
        assert ctl.counters() == runs["j_part_counters"]
        if tier == "disk":
            st = fm._row_store
            np.testing.assert_array_equal(st.inject.rng.random_sample(5),
                                          runs["j_io_next"])
            assert st.inject.injected == runs["j_part_io"]["injected"]
        fm.finalize()
    # a torn .rows snapshot (a byte of a row its CRC sidecar records as
    # written): --resume auto skips the candidate
    bad = tmp_path / "bad"
    shutil.copytree(os.path.dirname(path), bad)
    rows = bad / "run_state_ep1_r5.rows"
    nb = int(np.prod(jrows["errors"].shape[1:])) * 4
    row = int(np.flatnonzero(np.load(rows / "errors.crc.npy")
                             != jhs._crc32_zeros(0, nb))[0])
    with open(rows / "errors.f32", "r+b") as f:
        f.seek(row * nb + 64)
        f.write(b"\x7f")
    assert tck.find_resume_checkpoint(str(bad)) is None


def test_port_rows_run_state_readable_by_jax(runs, tmp_path):
    """The port's disk-tier run state passes JAX's discovery (checksum and
    the .rows CRCs) and its snapshot restores in JAX's row store."""
    path = runs["t_rs"]
    found = jck.find_resume_checkpoint(os.path.dirname(path),
                                       return_contents=True)
    assert found is not None and found[0] == path
    flat, meta = found[1]
    assert "io/rng_keys" in flat and meta["io_fault"] is not None
    snap = os.path.join(os.path.dirname(path), meta["client_store"]["dir"])
    st = jhs.MemmapRowStore(str(tmp_path / "j"), NCLIENTS,
                            {m: tuple(meta["client_store"]["members"][m]
                                      ["shape"]) for m in MEMBERS})
    st.restore_snapshot(snap, meta["client_store"])
    for m in MEMBERS:
        np.testing.assert_array_equal(st.read_full(m), runs["t_rs_rows"][m])
        np.testing.assert_array_equal(
            jhs.read_snapshot_member(snap, meta["client_store"], m),
            runs["t_rs_rows"][m])
    st.close()


def _cv_argv(tmp, extra=()):
    return ["--device", "cpu", "--dataset_name", "CIFAR10", "--dataset_dir",
            str(tmp / "data"), "--num_epochs", "1", "--num_workers", "4",
            "--local_batch_size", "4", "--iid", "--num_clients", "8",
            "--lr_scale", "0.01", "--pivot_epoch", "0.5", "--seed", "0",
            "--train_dataloader_workers", "0"] + SKETCH_LOCAL + list(extra)


@pytest.fixture
def cv_env(monkeypatch, tmp_path):
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "8")
    monkeypatch.setenv("COMMEFFICIENT_RUN_DIR", str(tmp_path / "run"))
    for k, v in TIERS["disk"].items():
        monkeypatch.setenv(k, v)
    from commefficient_torch import cv_train

    return cv_train


def test_disk_resume_auto_bit_exact(cv_env, tmp_path):
    """cv_train on the disk tier saves a run state every 2 rounds (the
    rows beside it, 2 kept); resumed from the round-2 state in a fresh
    directory, the final weights and the summary equal the continuous
    run's bit for bit."""
    full = tmp_path / "full"
    s_full = cv_env.main(_cv_argv(tmp_path, [
        "--checkpoint", "--checkpoint_path", str(full),
        "--checkpoint_every_rounds", "2", "--keep_checkpoints", "2"]))
    names = sorted(os.listdir(full))
    states = [n for n in names if n.endswith(".npz") and "run_state" in n]
    assert len(states) == 2, names
    assert sorted(n for n in names if n.endswith(".rows")) == \
        [n[:-4] + ".rows" for n in states]
    assert "client_state" in names  # the default --state_dir
    res = tmp_path / "res"
    res.mkdir()
    first = sorted(states)[0]
    shutil.copy(full / first, res / first)
    shutil.copytree(full / (first[:-4] + ".rows"),
                    res / (first[:-4] + ".rows"))
    s_res = cv_env.main(_cv_argv(tmp_path, [
        "--checkpoint", "--checkpoint_path", str(res), "--resume", "auto"]))
    a = np.load(full / "ResNet9.npz")
    b = np.load(res / "ResNet9.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("train_loss", "train_acc", "test_loss", "test_acc"):
        assert s_full[k] == s_res[k] or (np.isnan(s_full[k])
                                         and np.isnan(s_res[k])), k


def test_obs_report_renders_host_offload(cv_env, tmp_path):
    """A flip drill with a scrub: corrupt rows detected and repaired or
    quarantined, the io_corrupt watch rule fires, and obs_report's "Host
    offload" section reads the port's log."""
    cv_env.main(_cv_argv(tmp_path, [
        "--checkpoint_path", str(tmp_path / "ck"),
        "--inject_io_fault", "flip=0.05,seed=1", "--io_scrub_rows", "4"]))
    run = tmp_path / "run"
    events = [json.loads(x) for x in open(run / "telemetry.jsonl")]
    start = next(e for e in events if e["ev"] == "run_start")
    info = start.get("run", start)
    assert info["state_placement"] == "disk"
    assert info["state_io"]["scrub_rows"] == 4
    rounds = [e for e in events if e["ev"] == "round"]
    assert rounds and all("offload" in e for e in rounds)
    counters = next(e for e in events if e["ev"] == "io_counters")
    assert counters["corrupt"] > 0
    assert sum(e["offload"].get("io_corrupt", 0) for e in rounds) > 0
    alerts = [e for e in events if e["ev"] == "watch_alert"]
    assert any("io_corrupt" in json.dumps(a) for a in alerts), alerts
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "obs_report.py"),
         str(run)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "Host offload" in proc.stdout
    assert "disk" in proc.stdout


def test_two_ranks_offload_match_jax(runs):
    jw, jrows = runs["j_dist"]
    outs = runs["dist"]
    assert [o["tier"] for o in outs[0]] == ["host", "disk", "disk"]
    for n in range(3):
        r0, r1 = outs[0][n], outs[1][n]
        for a, b in zip(r0["w"], r1["w"]):
            np.testing.assert_array_equal(a, b)
        for m in MEMBERS:
            np.testing.assert_array_equal(r0["rows"][m], r1["rows"][m])
            np.testing.assert_allclose(r0["rows"][m], jrows[m], rtol=RTOL,
                                       atol=ATOL, err_msg=f"run {n} {m}")
        for rnd, (tw, w) in enumerate(zip(r0["w"], jw)):
            np.testing.assert_allclose(tw, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"run {n} round {rnd}")
        if r0["dirs"] is not None:
            assert r0["dirs"] == ["rank0", "rank1"]
    # host and disk tiers over the ranks: bit for bit
    for a, b in zip(outs[0][0]["w"], outs[0][1]["w"]):
        np.testing.assert_array_equal(a, b)
