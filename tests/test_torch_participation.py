"""The port's participation layer (``commefficient_torch/federated/
participation.py``, the sampler's cohorts, ``FedModel``'s fault split,
late landing and async buffer) against the JAX package's on the CPU, with
the same seeds and the same numpy inputs on both sides.

- The parsers and ``staleness_weight``: the same values, and a malformed
  spec raises the same exception type.
- The fold helpers against JAX's jitted ones: bit-equal where the helper
  is one rounding step (``_transmit_sum``, ``_masked_count``,
  ``_count_masked``, ``_safe_mean``, ``_finite_ok``), otherwise
  ``allclose(rtol=1e-6, atol=1e-7)``: a multiply-add may be contracted
  into one rounding by XLA and not by PyTorch (the atol covers a sum
  that cancels to near zero).
- ``FedSampler``: uniform, weighted and stratified cohorts identical to
  JAX's for 3 epochs; ``requeue``, ``retry_limit``, ``quarantine`` and
  the state round trip identical; the native batch plane pads a short
  cohort as the per-item path does.
- ``apply_faults``: the masks and ``info`` records of 20 rounds identical
  to JAX's controller (each with its own sampler).
- A tiny ResNet9 sketch round, 6 rounds under ``--participation 0.75
  --inject_client_fault drop=0.1,slow=0.3,corrupt=0.1,delay=2,seed=3``,
  synchronous and with ``--async_buffer 3``: the cohort records and the
  counters bit for bit; from JAX's folded table each round, the top-k
  threshold and the kept set bit for bit (each package running its own
  query and threshold); the port's own folded table, held sums and
  weights within ``rtol=1e-4, atol=1e-6`` (the tolerance of
  ``tests/test_torch_rounds.py``: the client gradients come from another
  framework's convolutions).
- Full participation (the layer attached, nothing set) is bit-identical
  to no layer; a JAX run state with ``part/*``, ``drop_rng/*`` and the
  sampler's ``retry`` restores, and the port's next draws equal JAX's; a
  port resume taken mid-buffer is bit-equal to the continuous run.
- ``scripts/obs_report.py``, unedited in a subprocess, renders the
  participation and async sections of a port ``cv_train`` log with totals
  equal to the controller's ``counters()``; JAX's ``parse_heartbeat``
  reads the port's ``buf`` / ``stale`` heartbeat.

The 2-rank ``--server_shard`` fold is in ``tests/test_torch_dist_rounds.py``
(its spawn).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.data_utils.fed_sampler import FedSampler as JSampler  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated import LambdaLR as JLambdaLR  # noqa: E402
from commefficient_tpu.federated import checkpoint as jck  # noqa: E402
from commefficient_tpu.federated import participation as jp  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_tpu.profiling import parse_heartbeat  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.data_utils.fed_sampler import FedSampler as TSampler  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR  # noqa: E402
from commefficient_torch.federated import checkpoint as tck  # noqa: E402
from commefficient_torch.federated import participation as tp  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402
from commefficient_torch.profiling import Heartbeat  # noqa: E402

import importlib  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
W, B, NCLIENTS, K, ROUNDS = 4, 4, 8, 500, 6
FAULTS = "drop=0.1,slow=0.3,corrupt=0.1,delay=2,seed=3"
ARGV = ["--mode", "sketch", "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", str(K), "--num_cols", "2048", "--num_rows", "3",
        "--num_blocks", "2", "--num_workers", str(W), "--num_devices", "1",
        "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
        "--local_batch_size", str(B), "--seed", "0"]
PART = ["--participation", "0.75", "--inject_client_fault", FAULTS]
RTOL, ATOL = 1e-4, 1e-6


class FakeDataset:
    def __init__(self, data_per_client):
        self.data_per_client = np.asarray(data_per_client, np.int64)
        self.num_clients = len(data_per_client)

    def __len__(self):
        return int(self.data_per_client.sum())


# -- the parsers -------------------------------------------------------------

@pytest.mark.parametrize("spec", ["", None, "0.5", "1.0", "0.01", "3", "4",
                                  "0", "-1", "2.5", "5", "abc"])
def test_parse_participation(spec):
    def run(f):
        try:
            return ("ok", f(spec, 4))
        except Exception as e:  # noqa: BLE001 - the type is compared
            return ("raise", type(e))
    assert run(tp.parse_participation) == run(jp.parse_participation)


@pytest.mark.parametrize("spec", [
    "drop=0.1", "drop=0.1,slow=0.2,corrupt=0.05,delay=2,seed=7",
    " slow=0.5 , delay=3 ,", "corrupt=0.2,quarantine_after=1",
    "drop=1.0", "drop=0.6,slow=0.5", "delay=2", "drop=0.1,delay=0",
    "drop=0.1,quarantine_after=0", "drop=0.1,bogus=1", "drop", "drop=x",
    "drop=0.1,seed=1.5", ""])
def test_parse_client_fault(spec):
    def run(f):
        try:
            s = f(spec)
            return ("ok", (s.drop, s.slow, s.corrupt, s.delay, s.seed,
                           s.quarantine_after, s.active, s.spec()))
        except Exception as e:  # noqa: BLE001 - the type is compared
            return ("raise", type(e))
    assert run(tp.parse_client_fault) == run(jp.parse_client_fault)


def test_staleness_weight():
    for d in range(6):
        for decay in (0.25, 0.5, 0.9, 1.0):
            assert tp.staleness_weight(d, decay) == \
                jp.staleness_weight(d, decay)


# -- the fold helpers --------------------------------------------------------

def _pair(shape, seed, nan=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if nan:
        a[1, 2] = np.nan
    return torch.from_numpy(a), jnp.asarray(a)


def test_fold_helpers_match_jax():
    shape = (3, 2048)
    (g, jg), (s, js) = _pair(shape, 0), _pair(shape, 1)
    (bad, jbad) = _pair(shape, 2, nan=True)
    count, lwc, w = 13.0, 0.5 * 7.0, 0.5
    f32 = np.float32

    def eq(a, b):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def close(a, b):
        # a multiply-add: XLA may contract it into one rounding; where the
        # sum cancels to near zero, one rounding of the O(10) operands
        # (about 1e-6 apart) is a large share of it, hence the atol
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)

    eq(tp._transmit_sum(g, tp._f32(count)), jp._transmit_sum(jg, f32(count)))
    close(tp._fold_mean(g, tp._f32(count), s, tp._f32(lwc), tp._f32(w)),
          jp._fold_mean(jg, f32(count), js, f32(lwc), f32(w)))
    close(tp._fold_sum(g, s, tp._f32(w)), jp._fold_sum(jg, js, f32(w)))
    for x, jx in ((g, jg), (bad, jbad)):
        assert bool(tp._finite_ok(x)) == bool(jp._finite_ok(jx))
    ok_t, ok_j = tp._finite_ok(s), jp._finite_ok(js)
    nok_t, nok_j = tp._finite_ok(bad), jp._finite_ok(jbad)
    for ok, jok, c in ((ok_t, ok_j, s), (nok_t, nok_j, bad)):
        jc = jnp.asarray(c.numpy())
        close(tp._masked_fold(g, c, tp._f32(0.25), ok),
              jp._masked_fold(jg, jc, f32(0.25), jok))
        acc = torch.tensor(5.0)
        eq(tp._masked_count(acc, tp._f32(3.5), ok),
           jp._masked_count(f32(5.0), f32(3.5), jok))
        eq(tp._count_masked(acc, ok), jp._count_masked(f32(5.0), jok))
    # a masked NaN never reaches the accumulator
    assert torch.isfinite(tp._masked_fold(g, bad, 0.5, nok_t)).all()
    assert float(tp._count_masked(None, nok_t)) == 1.0
    for den in (0.0, 0.5, 7.0):
        eq(tp._safe_mean(g, torch.tensor(den)),
           jp._safe_mean(jg, f32(den)))


# -- the sampler -------------------------------------------------------------

def _cohorts(cls, sampling, participation, epochs=3, seed=5):
    ds = FakeDataset([5, 0, 3, 9, 1, 7, 4, 6, 2, 8])
    s = cls(ds, 4, 2, participation=participation, sampling=sampling)
    np.random.seed(seed)
    out = []
    for _ in range(epochs):
        for ids, idx in s.iter_structured():
            out.append((np.asarray(ids).tolist(),
                        [np.asarray(i).tolist() for i in idx]))
    return out, np.random.rand()


@pytest.mark.parametrize("sampling", ["uniform", "weighted", "stratified"])
@pytest.mark.parametrize("participation", [None, 3, 1])
def test_sampler_cohorts_match_jax(sampling, participation):
    assert _cohorts(TSampler, sampling, participation) == \
        _cohorts(JSampler, sampling, participation)


def test_sampler_requeue_quarantine_state_match_jax():
    def run(cls):
        ds = FakeDataset([6, 6, 6, 6, 6])
        s = cls(ds, 3, 2, participation=2, retry_limit=2)
        np.random.seed(9)
        it = s.iter_structured()
        log = []
        for rnd in range(14):
            try:
                ids, idx = next(it)
            except StopIteration:
                it = s.iter_structured()
                ids, idx = next(it)
            log.append(np.asarray(ids).tolist())
            if rnd % 2 == 0:
                log.append(s.requeue(ids, [len(i) for i in idx]))
            if rnd == 5:
                s.quarantine(int(ids[0]))
            if rnd == 7:
                state = s.get_state()
                log.append({k: v.tolist() for k, v in state.items()})
                s2 = cls(ds, 3, 2, participation=2, retry_limit=2)
                s2.set_state(state)
                s, it = s2, s2.iter_structured()
        log.append((s.requeues, s.abandoned,
                    s.quarantined_clients.tolist()))
        # an older state without the participation keys
        s3 = cls(ds, 3, 2)
        s3.set_state({"permuted": state["permuted"],
                      "cursor": state["cursor"]})
        log.append(s3._retry.tolist() + s3._quarantined.tolist())
        return log
    assert run(TSampler) == run(JSampler)


def test_native_plane_pads_a_short_cohort(tmp_path):
    """A cohort smaller than ``--num_workers`` (``participation`` 2 of 4
    slots): the native batch plane pads the empty slots as the per-item
    path does (zero inputs, masks, worker masks and ids)."""
    from commefficient_torch.data_utils import FedCIFAR10
    from commefficient_torch.data_utils import transforms as ttr
    from commefficient_torch.data_utils.loader import FedLoader

    os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"] = "4"
    try:
        ds = FedCIFAR10(str(tmp_path), "CIFAR10", ttr.cifar10_train_transforms,
                        True, 4, train=True, seed=3)
    finally:
        del os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"]
    out = []
    for native in (True, False):
        loader = FedLoader(ds, 4, 3, use_native=native)
        assert loader.use_native == native
        loader.sampler.participation = 2
        np.random.seed(1)
        out.append([b for _, b in zip(range(3), loader)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a["worker_mask"], [1, 1, 0, 0])
        for k in ("targets", "mask", "client_ids", "worker_mask"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_allclose(a["inputs"], b["inputs"], atol=1e-5)
        assert not a["inputs"][2:].any() and not a["mask"][2:].any()
        assert not a["client_ids"][2:].any()


# -- the controller ----------------------------------------------------------

def test_apply_faults_match_jax():
    def run(pkg, sampler_cls):
        ds = FakeDataset([8] * 10)
        sampler = sampler_cls(ds, W, 2, participation=3, retry_limit=1)
        np.random.seed(4)
        it = sampler.iter_structured()
        sched = pkg.parse_client_fault(
            "drop=0.2,slow=0.2,corrupt=0.2,delay=1,seed=5,"
            "quarantine_after=2")
        ctl = pkg.ParticipationController(schedule=sched, sampler=sampler,
                                          target=3)
        log = []
        for rnd in range(20):
            try:
                ids, idx = next(it)
            except StopIteration:
                it = sampler.iter_structured()
                ids, idx = next(it)
            n = len(ids)
            batch = {"client_ids": np.zeros(W, np.int32),
                     "worker_mask": np.zeros(W, np.float32),
                     "mask": np.zeros((W, 2), np.float32),
                     "inputs": np.ones((W, 2, 3), np.float32)}
            batch["client_ids"][:n] = ids
            batch["worker_mask"][:n] = 1.0
            for w, i in enumerate(idx):
                batch["mask"][w, :len(i)] = 1.0
            primary, late, info = ctl.apply_faults(batch, rnd)
            log.append((primary["worker_mask"].tolist(),
                        primary["mask"].tolist(),
                        None if late is None else
                        (late["worker_mask"].tolist(),
                         late["mask"].tolist()), info))
        log.append((ctl.counters(), sampler.quarantined_clients.tolist(),
                    sampler.requeues, sampler.abandoned))
        return log
    assert run(tp, TSampler) == run(jp, JSampler)


# -- the round against JAX ---------------------------------------------------

def _batch(rnd):
    """A round of 3 live slots and a padded one, as the loader gives a
    0.75 cohort of 4 slots."""
    rng = np.random.RandomState(200 + rnd)
    mask = np.ones((W, B), np.float32)
    wmask = np.ones(W, np.float32)
    mask[W - 1] = 0.0
    wmask[W - 1] = 0.0
    if rnd == 1:
        mask[1, 3] = 0.0   # a short client
    ids = rng.choice(NCLIENTS, W, replace=False).astype(np.int32)
    ids[W - 1] = 0
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": mask, "client_ids": ids, "worker_mask": wmask}


def _lam(step):
    return 0.05 * (1 + step)


def _jax(argv):
    jargs = j_parse(argv=argv + ["--no_telemetry"])
    jm = JResNet9(channels=TINY)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    jopt = JFedOptimizer(jfm, jargs)
    jsched = JLambdaLR(jopt, _lam)
    ctl = jp.attach_participation(jargs, jfm)
    return jfm, jopt, jsched, ctl


def _port(flat0, argv):
    args = t_parse(argv=argv + ["--device", "cpu", "--no_telemetry"])
    tm = ResNet9(channels=TINY)
    train, val = t_losses(tm)
    fm = FedModel(tm, train, args, val, num_clients=NCLIENTS,
                  init_params=flat_from_jax(flat0, ParamLayout(tm)),
                  device="cpu")
    opt = FedOptimizer(fm, args)
    sched = LambdaLR(opt, _lam)
    return fm, opt, sched, tp.attach_participation(args, fm)


def _flat(fm):
    return fm.layout.unchunk(fm.ps_weights).numpy().copy()


def _round(fm, opt, sched, batch):
    """One round: the folded table (None when buffered), the server state
    before the step, the results and the cohort record."""
    sched.step()
    h = fm.begin_round(batch)
    buffered = fm._async_skip_server
    g = None if buffered else np.asarray(fm._round_ctx.gradient).copy()
    st = [np.asarray(x).copy() for x in opt.server_state[:2]]
    opt.step()
    res = fm.finish_round(h)
    return g, st, res, h.cohort


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("part")
    out = {"dir": d}
    for name, extra in (("sync", []), ("async", ["--async_buffer", "3"])):
        argv = ARGV + PART + extra
        jfm, jopt, jsched, jctl = _jax(argv)
        flat0 = np.asarray(ravel_pytree(jfm.params)[0])
        tfm, topt, tsched, tctl = _port(flat0, argv)
        rec = []
        for rnd in range(ROUNDS):
            b = _batch(rnd)
            j = _round(jfm, jopt, jsched, b)
            t = _round(tfm, topt, tsched, b)
            rec.append({
                "j": j, "t": t,
                "jw": np.asarray(ravel_pytree(jfm.params)[0]),
                "tw": _flat(tfm),
                "jc": jctl.counters(), "tc": tctl.counters(),
                "jheld": [np.asarray(c.transmit_sum) for c in
                          jctl.pending + list(getattr(jctl, "buffer", []))],
                "theld": [c.transmit_sum.numpy().copy() for c in
                          tctl.pending + list(tctl.buffer)]})
            if name == "sync" and rnd == 1:
                # a JAX run state with a pending straggler, a drawn
                # dropout stream and the sampler's retry state
                jfm._drop_rng.random_sample(3)
                out["jpath"] = jck.save_run_state(
                    str(d / "run_state_ep1_r2"), jfm, jopt, jsched,
                    next_epoch=0, totals=(0.0, 0.0),
                    mid_epoch={"rounds_done": 2, "sampler": {
                        "permuted": np.arange(40, dtype=np.int64),
                        "cursor": np.arange(NCLIENTS, dtype=np.int64),
                        "retry": np.arange(NCLIENTS, dtype=np.int64) % 3,
                        "quarantined": np.arange(NCLIENTS) == 5}})
                # the next draws of both streams, then back to where the
                # run stands
                states = (jctl.rng.get_state(), jfm._drop_rng.get_state())
                out["jafter"] = (jctl.rng.random_sample(4),
                                 jfm._drop_rng.random_sample(4))
                jctl.rng.set_state(states[0])
                jfm._drop_rng.set_state(states[1])
        out[name] = {"rounds": rec, "flat0": flat0, "jsketch": jfm.sketch,
                     "tsketch": tfm.sketch}
    return out


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_round_matches_jax(runs, mode):
    r = runs[mode]
    folds = buffered = landed = 0
    for rnd, x in enumerate(r["rounds"]):
        (jg, jst, jres, jcoh), (tg, tst, tres, tcoh) = x["j"], x["t"]
        what = f"{mode} round {rnd}"
        # the cohort record, the counters: bit for bit
        assert tcoh == jcoh, what
        assert x["tc"] == x["jc"], what
        landed += len((jcoh or {}).get("landed", []))
        # the held sums (pending stragglers, buffered contributions)
        assert len(x["theld"]) == len(x["jheld"]), what
        for a, b in zip(x["theld"], x["jheld"]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=what)
        assert (tg is None) == (jg is None), what
        if jg is None:
            buffered += 1
        else:
            folds += 1
            np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL,
                                       err_msg=what)
            # from JAX's folded table and state: the threshold and kept
            # set, each package running its own query and threshold
            vel, err = jst
            terr = torch.from_numpy(err) + (torch.from_numpy(jg)
                                            + 0.9 * torch.from_numpy(vel))
            jerr = jnp.asarray(err) + (jnp.asarray(jg)
                                       + 0.9 * jnp.asarray(vel))
            np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
            test_ = tsk.estimates_chunks(r["tsketch"], terr)
            jest = jsk.estimates_chunks(r["jsketch"], jerr)
            np.testing.assert_array_equal(test_.numpy(), np.asarray(jest))
            assert int(ttk.resolve_threshold(test_, K)) == \
                int(jtk.resolve_threshold(jest, K)), what
            tupd = tsk.unsketch_chunks(r["tsketch"], terr, K).numpy()
            jupd = np.asarray(jsk.unsketch_chunks(r["jsketch"], jerr, K))
            np.testing.assert_array_equal(np.flatnonzero(tupd),
                                          np.flatnonzero(jupd))
        (jl, ja, jd, ju), (tl, ta, td, tu) = jres, tres
        np.testing.assert_allclose(tl, jl, rtol=RTOL, err_msg=what)
        np.testing.assert_array_equal(ta, ja, err_msg=what)
        np.testing.assert_array_equal(tu, ju, err_msg=what)
        np.testing.assert_allclose(x["tw"], x["jw"], rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    c = r["rounds"][-1]["tc"]
    assert c["slows"] and c["drops"] and c["corrupts"]
    if mode == "sync":
        assert landed >= 2 and buffered == 0
    else:
        assert folds >= 2 and buffered >= 2 and c["folded"] > c["folds"]


def test_full_participation_is_bit_identical():
    flat0 = np.asarray(ravel_pytree(_jax(ARGV)[0].params)[0])
    ws = []
    for extra in ([], ["--participation", "1.0"]):
        fm, opt, sched, ctl = _port(flat0, ARGV + extra)
        assert (ctl is None) == (not extra)
        for rnd in range(4):
            _round(fm, opt, sched, _batch(rnd))
        ws.append((_flat(fm), opt.server_state.velocity.numpy().copy(),
                   opt.server_state.error.numpy().copy()))
    for a, b in zip(*ws):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_jax_run_state_restores(runs):
    flat0 = runs["sync"]["flat0"]
    fm, opt, sched, ctl = _port(np.zeros_like(flat0), ARGV + PART)
    _, _, mid = tck.load_run_state(runs["jpath"], fm, opt, sched)
    jflat = jck._read_npz(runs["jpath"])
    meta = json.loads(bytes(jflat.pop("meta_json")).decode())
    assert meta["participation"]["pending"], "no straggler held"
    # the counters, the ledgers and the held sums, bit for bit
    assert ctl.counters() == meta["participation"]["counters"]
    for i, c in enumerate(ctl.pending):
        np.testing.assert_array_equal(c.transmit_sum.numpy(),
                                      jflat[f"part/pending{i}/sum"])
        np.testing.assert_array_equal(c.ids, jflat[f"part/pending{i}/ids"])
    assert [(c.dispatch_round, c.due_round, c.count) for c in ctl.pending] \
        == [(p["dispatch_round"], p["due_round"], p["count"])
            for p in meta["participation"]["pending"]]
    # the sampler's retry and quarantine state
    np.testing.assert_array_equal(mid["sampler"]["retry"],
                                  np.arange(NCLIENTS) % 3)
    np.testing.assert_array_equal(mid["sampler"]["quarantined"],
                                  np.arange(NCLIENTS) == 5)
    # the next draws of the fault stream and the dropout stream
    jfault, jdrop = runs["jafter"]
    np.testing.assert_array_equal(ctl.rng.random_sample(4), jfault)
    np.testing.assert_array_equal(fm._drop_rng.random_sample(4), jdrop)


def test_mid_buffer_resume_is_bit_equal(tmp_path):
    flat0 = np.asarray(ravel_pytree(_jax(ARGV)[0].params)[0])
    argv = ARGV + PART + ["--async_buffer", "3"]
    fa, oa, sa, _ = _port(flat0, argv)
    for rnd in range(ROUNDS):
        _round(fa, oa, sa, _batch(rnd))
    fb, ob, sb, cb = _port(flat0, argv)
    for rnd in range(4):
        _round(fb, ob, sb, _batch(rnd))
    assert cb.buffer and cb.pending, "the save is not mid-buffer"
    args = fb.args
    args.checkpoint_path = str(tmp_path)
    path = tck.save_round_state(args, 0, 4, {
        "permuted": np.arange(4, dtype=np.int64),
        "cursor": np.zeros(NCLIENTS, np.int64)}, fb, ob, sb, (0.0, 0.0))
    fc, oc, sc, cc = _port(np.zeros_like(flat0), argv)
    tck.load_run_state(path, fc, oc, sc)
    assert cc.counters() == cb.counters()
    for rnd in range(4, ROUNDS):
        _round(fc, oc, sc, _batch(rnd))
    for a, b in ((_flat(fc), _flat(fa)),
                 (oc.server_state.velocity.numpy(),
                  oa.server_state.velocity.numpy()),
                 (oc.server_state.error.numpy(),
                  oa.server_state.error.numpy())):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_fault_run_from_a_state_without_the_layer_warns(runs, tmp_path):
    flat0 = runs["sync"]["flat0"]
    fm, opt, sched, _ = _port(flat0, ARGV)
    _round(fm, opt, sched, _batch(0))
    path = tck.save_run_state(str(tmp_path / "run_state_ep1"), fm, opt,
                              sched, next_epoch=1)
    fm2, opt2, sched2, _ = _port(flat0, ARGV + PART)
    with pytest.warns(UserWarning, match="restarts from its seed"):
        tck.load_run_state(path, fm2, opt2, sched2)
    fm3, opt3, sched3, _ = _port(flat0, ARGV)
    with pytest.warns(UserWarning, match="no participation layer"):
        tck.load_run_state(runs["jpath"], fm3, opt3, sched3)


# -- the event log and the heartbeat -----------------------------------------

@pytest.mark.parametrize("extra", [[], ["--async_buffer", "3"]],
                         ids=["sync", "async"])
def test_obs_report_renders_participation(tmp_path, monkeypatch, extra):
    from commefficient_torch import cv_train

    made = []

    def attach(*a, **k):
        made.append(tp.attach_participation(*a, **k))
        return made[-1]

    monkeypatch.setattr(cv_train, "attach_participation", attach)
    run = tmp_path / "run"
    monkeypatch.setenv("COMMEFFICIENT_RUN_DIR", str(run))
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "8")
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    cv_train.main(["--device", "cpu", "--dataset_name", "CIFAR10",
                   "--dataset_dir", str(tmp_path / "d"), "--num_epochs", "1",
                   "--num_workers", "4", "--local_batch_size", "4", "--iid",
                   "--num_clients", "8", "--mode", "sketch",
                   "--error_type", "virtual", "--local_momentum", "0",
                   "--virtual_momentum", "0.9", "--k", "500",
                   "--num_cols", "2048", "--num_rows", "3",
                   "--lr_scale", "0.01", "--pivot_epoch", "0.5",
                   "--seed", "0"] + PART + extra)
    ctl = made[0]
    c = ctl.counters()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "obs_report.py"),
         str(run), "--json"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    p = rep["participation"]
    assert p["client_fault"]["spec"] == tp.parse_client_fault(FAULTS).spec()
    assert (p["dropped"], p["slow"], p["corrupt"], p["requeued"],
            p["abandoned"], p["fault_skips"], p["quarantined"]) == (
        c["drops"], c["slows"], c["corrupts"], c["requeued"],
        c["abandoned"], c["fault_skips"], c["quarantined"])
    assert c["slows"] and c["drops"]
    if not extra:
        assert (p["landed"], p["expired"]) == (c["landed"], c["expired"])
        assert rep["async"] is None
    else:
        a = rep["async"]
        assert a["buffer"] == 3
        assert (a["folds"], a["folded_contributions"], a["server_version"],
                a["masked"], a["expired"]) == (
            c["folds"], c["folded"], c["server_version"], c["masked"],
            c["async_expired"])
        assert c["contributions"] == c["folded"] + c["buffered"] + \
            c["pending"] + c["async_expired"] + c["expired"]


def test_heartbeat_buf_stale_parsed_by_jax():
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        Heartbeat(enabled=True).round(12, epoch=1, loss=0.5, guard_ok=True,
                                      buffer=2, stale=3)
        Heartbeat(enabled=True).round(13, loss=0.25)
    a, b = (parse_heartbeat(line) for line in err.getvalue().splitlines())
    assert a == {"round": 12, "epoch": 1, "loss": 0.5, "guard_ok": True,
                 "buf": 2, "stale": 3}
    assert b == {"round": 13, "loss": 0.25}
