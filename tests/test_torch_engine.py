"""The port's pipelined round engine (``federated/engine.py``) on the CPU:
the drained results against per-round fetching, the fetches between
drains, the window bound, the NaN abort at drain time, the order of
``cohort_lookahead``, and the sampler's checkpoint seam against the JAX
package's sampler.

Drained values and the weights are compared bit for bit: the engine
changes when results are fetched, never what a round computes. The
window is checked with a stand-in model whose completion events record
their waits (on the CPU a round has no event to wait on).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_tpu.data_utils.fed_sampler import FedSampler as JSampler  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.data_utils.fed_sampler import FedSampler  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR  # noqa: E402
from commefficient_torch.federated.engine import (  # noqa: E402
    PipelinedRoundEngine,
    cohort_lookahead,
)
from commefficient_torch.federated.losses import make_cv_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.profiling import host_sync_monitor  # noqa: E402

TINY = (("prep", 4), ("layer1", 8), ("layer2", 8), ("layer3", 8))
W, B, NCLIENTS, ROUNDS = 2, 2, 6, 10
ARGV = ["--mode", "sketch", "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", "200", "--num_cols", "1024", "--num_rows", "3",
        "--num_blocks", "2", "--num_workers", str(W),
        "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
        "--local_batch_size", str(B), "--seed", "0", "--device", "cpu",
        "--num_epochs", "2"]


def _batch(rnd, nan=False):
    rng = np.random.RandomState(200 + rnd)
    inputs = rng.randn(W, B, 32, 32, 3).astype(np.float32)
    if nan:
        inputs[0, 0, 0, 0, 0] = np.nan
    mask = np.ones((W, B), np.float32)
    wmask = np.ones(W, np.float32)
    if rnd % 4 == 3:  # a padded slot now and then
        mask[1] = 0.0
        wmask[1] = 0.0
    return {"inputs": inputs,
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": mask,
            "client_ids": rng.choice(NCLIENTS, W, replace=False)
            .astype(np.int32),
            "worker_mask": wmask}


def _setup():
    args = t_parse(argv=ARGV)
    model = ResNet9(channels=TINY)
    train, val = make_cv_losses(model)
    fm = FedModel(model, train, args, val, num_clients=NCLIENTS,
                  device="cpu")
    opt = FedOptimizer(fm, args)
    sched = LambdaLR(opt, lambda step: 0.1 * (1 + step) / 10)
    return fm, opt, sched


def _flat(fm):
    return fm.layout.unchunk(fm.ps_weights).numpy().copy()


def _assert_values_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def reference():
    """The reference loop: ``sched.step(); model(batch); opt.step()``."""
    fm, opt, sched = _setup()
    out = []
    for rnd in range(ROUNDS):
        sched.step()
        out.append(fm(_batch(rnd)))
        opt.step()
    return out, _flat(fm)


@pytest.mark.parametrize("drain_every,window", [(1, 1), (8, 2), (3, 5)])
def test_drain_parity(reference, drain_every, window):
    ref, ref_w = reference
    fm, opt, sched = _setup()
    eng = PipelinedRoundEngine(fm, opt, sched, window=window,
                               drain_every=drain_every)
    got = []
    for rnd in range(ROUNDS):
        got.extend(eng.submit(_batch(rnd)))
    got.extend(eng.close())
    assert [r.index for r in got] == list(range(ROUNDS))
    assert eng.pending == 0
    assert eng.drains == -(-ROUNDS // drain_every)
    for r, want in zip(got, ref):
        _assert_values_equal(r.values, want)
    np.testing.assert_array_equal(_flat(fm), ref_w)
    assert fm.rounds_dispatched == ROUNDS


def test_zero_fetches_between_drains():
    fm, opt, sched = _setup()
    eng = PipelinedRoundEngine(fm, opt, sched, window=2, drain_every=4)
    fetches = []
    for rnd in range(ROUNDS):
        with host_sync_monitor(strict=True) as counter:
            res = eng.submit(_batch(rnd))
        fetches.append((len(res), counter.count))
    with host_sync_monitor() as counter:
        tail = eng.drain()
    # a drain round fetches its pending rounds with one materialize
    assert fetches == [(0, 0), (0, 0), (0, 0), (4, 1)] * 2 + [(0, 0)] * 2
    assert (len(tail), counter.count) == (2, 1)
    # the handles carry the global dispatch index
    assert [h.round_no for h in (fm.begin_round(_batch(0)),)] == [ROUNDS]
    fm._round_ctx = None


class _Event:
    def __init__(self, log, idx):
        self.log, self.idx = log, idx

    def synchronize(self):
        self.log.append(self.idx)


class _Handle:
    def __init__(self, idx, done=None):
        self.round_no, self.done = idx, done


class _StubModel:
    """Begin/seal/finish with completion events that record their waits."""

    def __init__(self):
        self.rounds_dispatched = 0
        self.waits = []
        self.finished = []

    def begin_round(self, batch):
        h = _Handle(self.rounds_dispatched)
        self.rounds_dispatched += 1
        return h

    def seal_round(self, h):
        return _Handle(h.round_no, _Event(self.waits, h.round_no))

    def finish_rounds(self, handles, on_round=None):
        self.finished.append([h.round_no for h in handles])
        out = [[np.zeros(1), np.zeros(1), np.zeros(1), np.zeros(1)]
               for _ in handles]
        for h, values in zip(handles, out):
            if on_round is not None:
                on_round(h, values)
        return out


class _StubOpt:
    def step(self):
        pass


@pytest.mark.parametrize("window", [1, 2, 3])
def test_window_bound(window):
    m = _StubModel()
    eng = PipelinedRoundEngine(m, _StubOpt(), window=window, drain_every=6)
    for t in range(14):
        eng.submit(None)
        # after the submit of round t, the rounds up to t - window of the
        # undrained run have completed, and no later one was waited on
        assert all(w <= t - window for w in m.waits)
        assert eng.pending <= 6
    assert m.finished == [[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11]]
    # one wait for each round submitted with `window` more behind it in
    # the same undrained run
    expect = [t - window for t in range(14)
              if (t % 6) >= window]
    assert m.waits == expect
    assert eng.window_waits == len(expect)


def test_heartbeat_lines(monkeypatch, capsys):
    """``COMMEFFICIENT_HEARTBEAT=1``: one stderr line per drained round,
    with its global dispatch index and mean loss; nothing when unset."""
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("COMMEFFICIENT_HEARTBEAT", "1")
        else:
            monkeypatch.delenv("COMMEFFICIENT_HEARTBEAT", raising=False)
        m = _StubModel()
        eng = PipelinedRoundEngine(m, _StubOpt(), window=1, drain_every=2)
        for _ in range(3):
            eng.submit(None)
        eng.close()
        err = capsys.readouterr().err.splitlines()
        want = [f"HEARTBEAT round={i} loss=0" for i in range(3)]
        assert err == (want if armed else [])


class _Loader:
    """A stand-in loader: fixed batches, one with a NaN input."""

    def __init__(self, n, nan_at):
        self.batches = [_batch(i, nan=(i == nan_at)) for i in range(n)]
        self.dataset = type("D", (), {"num_clients": NCLIENTS})()
        self.sampler = None

    def steps_per_epoch(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_nan_abort_at_drain_time(capsys):
    from commefficient_torch import cv_train

    fm, opt, sched = _setup()
    args = t_parse(argv=ARGV + ["--metrics_drain_every", "4"])
    out = cv_train.run_batches(fm, opt, sched, _Loader(10, nan_at=1), True,
                               1, args)
    assert all(np.isnan(x) for x in out)
    assert "IS NAN, TERMINATING TRAINING" in capsys.readouterr().out
    # the NaN round (1) was found when rounds 0-3 drained: 4 dispatched
    assert fm.rounds_dispatched == 4


def test_cohort_lookahead_order():
    log = []

    class Loader:
        def __iter__(self):
            for i in range(3):
                log.append(("draw", i))
                yield {"client_ids": np.array([i])}

    class Model:
        def prefetch_cohort(self, batch):
            log.append(("prefetch", int(batch["client_ids"][0])))

    for batch in cohort_lookahead(Loader(), Model()):
        log.append(("body", int(batch["client_ids"][0])))
    assert log == [("draw", 0), ("body", 0), ("draw", 1), ("prefetch", 1),
                   ("body", 1), ("draw", 2), ("prefetch", 2), ("body", 2)]
    # a model without prefetch_cohort: the plain loop's batches
    assert [b["client_ids"][0] for b in
            cohort_lookahead(Loader(), object())] == [0, 1, 2]


class _Dataset:
    def __init__(self, sizes):
        self.data_per_client = np.asarray(sizes)
        self.num_clients = len(sizes)

    def __len__(self):
        return int(self.data_per_client.sum())


@pytest.mark.parametrize("lbs", [3, -1])
def test_sampler_state_replays_jax_cohorts(lbs):
    ds = _Dataset([5, 0, 7, 3, 9, 4])

    def draw(sampler, n, it=None):
        it = it if it is not None else sampler.iter_structured()
        return [(list(w), [list(x) for x in idx])
                for _, (w, idx) in zip(range(n), it)], it

    rounds = {}
    for name, cls in (("jax", JSampler), ("port", FedSampler)):
        np.random.seed(5)
        s = cls(ds, 2, lbs)
        assert s.get_state() is None
        head, it = draw(s, 3)
        state = s.get_state()
        rng = np.random.get_state()
        tail, _ = draw(s, 3, it)
        # a fresh sampler armed with the state and the RNG replays the tail
        s2 = cls(ds, 2, lbs)
        s2.set_state(state)
        np.random.set_state(rng)
        replay, _ = draw(s2, 3)
        assert replay == tail
        rounds[name] = (head, tail, state)
    (jh, jt, js), (th, tt, ts) = rounds["jax"], rounds["port"]
    assert th == jh and tt == jt
    for key in ("permuted", "cursor"):
        np.testing.assert_array_equal(ts[key], js[key])
        assert ts[key].dtype == js[key].dtype
