"""The port's watch plane, round tracer, step profiler and heartbeat
against the JAX package's on the CPU, mirroring ``tests/test_watch.py``
and ``tests/test_telemetry.py``.

- ``parse_watch_rules``: the grammar, the default rules, bad specs and
  unknown metrics give the JAX package's rules and errors.
- ``WatchEngine``: one seeded synthetic stream of drained round records
  (spikes, NaN and inf values, streaks, drifting dispatch stamps) gives
  the same alerts, events, cooldowns, EWMA state and reactions as
  JAX's engine.
- ``RoundTracer``: static windows start at their round and stop when it
  has drained, dynamic requests come from the watch plane, a window due
  while ``StepProfiler`` captures waits for the next submit (and the
  step profiler skips while a window captures), each capture writes
  ``trace.json`` into ``trace_round_<N>/``.
- The heartbeat line parses with the JAX package's ``parse_heartbeat``,
  the guard verdict included.
- The strict audit: with guards, telemetry, histograms and watch on, a
  non-drain submit makes no counted fetch and a drain one.
- An injected NaN fires the transmit rule at its round; the alert and
  the trace it requested read back from the log alone through
  ``scripts/obs_report.py``'s loader.
"""

import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_tpu import profiling as JP  # noqa: E402
from commefficient_tpu import telemetry as JT  # noqa: E402
from commefficient_torch import profiling as TP  # noqa: E402
from commefficient_torch import telemetry as TT  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR  # noqa: E402
from commefficient_torch.federated.engine import PipelinedRoundEngine  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the rules ---------------------------------------------------------------

GRAMMAR = ("loss>ewma*4@2->trace:5, error_norm>1e3, "
           "update_nnz<ewma*0.25->checkpoint, occupancy<1.5@3->log, "
           "update_hist_7>10, compute_ms>1e4, dispatch_to_drain_ms>1e5")


def test_rules_parse_as_jax():
    assert tuple(TT.parse_watch_rules(GRAMMAR)) == tuple(
        tuple(r) for r in JT.parse_watch_rules(GRAMMAR))
    assert TT.DEFAULT_WATCH_RULES == JT.DEFAULT_WATCH_RULES
    assert TT.WATCH_METRIC_NAMES == JT.WATCH_METRIC_NAMES
    for name in ("WATCH_WARMUP", "WATCH_EWMA_ALPHA", "WATCH_COOLDOWN",
                 "WATCH_TRACE_ROUNDS"):
        assert getattr(TT, name) == getattr(JT, name)
    rules = TT.parse_watch_rules(",".join(TT.DEFAULT_WATCH_RULES))
    assert len(rules) == len(JT.DEFAULT_WATCH_RULES)


@pytest.mark.parametrize("bad", ["loss=4", "loss>ewma*0", "loss>x",
                                 "loss>1->explode", ">1",
                                 "eror_norm>ewma*8@3", "loss>1@0"])
def test_bad_rules_raise_as_jax(bad):
    with pytest.raises((ValueError, AssertionError)) as je:
        JT.parse_watch_rules(bad)
    with pytest.raises((ValueError, AssertionError)) as te:
        TT.parse_watch_rules(bad)
    assert te.type is je.type
    if "unknown metric" in str(je.value):
        assert "unknown metric" in str(te.value)


class _FakeRT:
    def __init__(self):
        self.events = []

    def event(self, ev, **fields):
        self.events.append(dict(fields, ev=ev))


class _FakeTracer:
    """Grants every other request, as a busy tracer would refuse some."""

    def __init__(self):
        self.requests = []

    def request(self, n):
        self.requests.append(n)
        return len(self.requests) % 2 == 1


def _stream(n=160, seed=0):
    """Seeded drained records: slow drifts, spikes, streaks, NaN and inf
    values, missing metrics, prefetch misses, dispatch stamps."""
    rs = np.random.RandomState(seed)
    t = 1000.0
    out = []
    for rnd in range(n):
        m = {"transmit_norm": float(1 + 0.1 * rs.randn()),
             "error_norm": float(2 + 0.01 * rnd),
             "qres_norm": 0.0,
             "update_nnz": float(500 - (rnd > 90) * 450),
             "update_hist_7": float(rs.randint(0, 20))}
        if rnd in (30, 31, 32):
            m["transmit_norm"] = 50.0
        if rnd == 60:
            m["transmit_norm"] = float("nan")
        if rnd == 61:
            m["error_norm"] = float("inf")
        if rnd % 17 == 5:
            del m["error_norm"]
        t += 0.01 if rnd % 40 < 30 else 0.5
        rec = {"round": rnd, "metrics": m, "t_dispatch": t,
               "loss": float(2.0 + rs.rand() + (20 if 70 <= rnd < 74
                                                else 0)),
               "occupancy": 2 if rnd % 50 < 40 else 1,
               "compute_ms": float(10 + rs.rand())}
        if rnd % 3 == 0:
            rec["offload"] = {"prefetch": "miss" if rnd > 120 else "hit"}
        out.append(rec)
    return out


def test_watch_engine_matches_jax_on_one_stream():
    spec = ",".join(TT.DEFAULT_WATCH_RULES + (
        "transmit_norm>5@2->checkpoint", "error_norm>ewma*1.02@2",
        "update_hist_7<2", "loss>ewma*3->trace:2", "compute_ms>10.5@3"))
    engines = []
    for mod in (JT, TT):
        rt, tr = _FakeRT(), _FakeTracer()
        eng = mod.WatchEngine(mod.parse_watch_rules(spec), telemetry=rt,
                              tracer=tr)
        pops = []
        for rec in _stream():
            eng.observe(dict(rec, metrics=dict(rec["metrics"])))
            pops.append(eng.pop_checkpoint())
        engines.append((eng, rt, tr, pops))
    (je, jrt, jtr, jpops), (te, trt, ttr, tpops) = engines
    assert je.alerts > 10
    assert te.fired == je.fired and te.alerts == je.alerts
    assert tpops == jpops and any(jpops)
    assert ttr.requests == jtr.requests and jtr.requests
    assert len(trt.events) == len(jrt.events)
    for a, b in zip(trt.events, jrt.events):
        assert set(a) == set(b)
        for k in a:
            if isinstance(b[k], float) and math.isnan(b[k]):
                assert math.isnan(a[k])
            else:
                assert a[k] == b[k], (k, a[k], b[k])
    for a, b in zip(te._state, je._state):
        assert (a.ewma, a.n, a.consec, a.cooldown_until, a.fired) == \
            (b.ewma, b.n, b.consec, b.cooldown_until, b.fired)


def test_watch_reactions():
    w = TT.WatchEngine(TT.parse_watch_rules("loss>2->checkpoint"),
                       telemetry=_FakeRT())
    w.observe({"round": 0, "loss": 5.0})
    assert w.checkpoint_pending
    assert w.pop_checkpoint() and not w.pop_checkpoint()
    tracer = TP.RoundTracer("unused")
    w = TT.WatchEngine(TT.parse_watch_rules("loss>2->trace:2"),
                       telemetry=_FakeRT(), tracer=tracer)
    w.observe({"round": 3, "loss": 9.0})
    assert tracer._requests == 2


# ---- the engine-level planes -------------------------------------------------

TINY = (("prep", 4), ("layer1", 8), ("layer2", 8), ("layer3", 8))
ARGV = ["--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--k", "200", "--num_cols",
        "1024", "--num_rows", "3", "--num_blocks", "2", "--num_workers",
        "2", "--num_clients", "6", "--dataset_name", "CIFAR10",
        "--local_batch_size", "2", "--seed", "0", "--device", "cpu",
        "--num_epochs", "2"]


def _batch(rnd):
    rs = np.random.RandomState(500 + rnd)
    return {"inputs": rs.randn(2, 2, 32, 32, 3).astype(np.float32),
            "targets": rs.randint(0, 10, size=(2, 2)).astype(np.int64),
            "mask": np.ones((2, 2), np.float32),
            "client_ids": rs.choice(6, 2, replace=False).astype(np.int32),
            "worker_mask": np.ones(2, np.float32)}


def _engine(tmp_path, extra=(), drain_every=8, rules=None, tracer=None):
    args = t_parse(argv=ARGV + list(extra))
    model = ResNet9(channels=TINY)
    train, val = make_cv_losses(model)
    fm = FedModel(model, train, args, val, num_clients=6, device="cpu")
    opt = FedOptimizer(fm, args)
    rt = TT.RunTelemetry(str(tmp_path / "telemetry.jsonl"),
                         run_info={"mode": "sketch",
                                   "grad_size": fm.grad_size,
                                   "guards": bool(args.guards)},
                         schema=TT.metric_schema(True))
    if rules is not None:
        rt.watch = TT.WatchEngine(rules, telemetry=rt, tracer=tracer)
    fm.telemetry, fm.tracer = rt, tracer
    eng = PipelinedRoundEngine(fm, opt, LambdaLR(opt, lambda s: 0.1),
                               window=2, drain_every=drain_every)
    return fm, eng, rt


def test_zero_syncs_with_guards_hists_and_watch(tmp_path):
    """Guards, telemetry, histograms and watch on: no counted fetch in a
    non-drain submit (strict: on a card the stream sync debug mode is
    armed too), one in a drain; every round lands a full-schema line."""
    rules = TT.parse_watch_rules(",".join(TT.DEFAULT_WATCH_RULES))
    fm, eng, rt = _engine(tmp_path, ["--guards", "--snapshot_every", "4"],
                          drain_every=6, rules=rules)
    eng.submit(_batch(0))
    with TP.host_sync_monitor(strict=True) as counter:
        for rnd in range(1, 5):
            assert eng.submit(_batch(rnd)) == []
            assert counter.count == 0
    with TP.host_sync_monitor() as counter:
        assert len(eng.submit(_batch(5))) == 6
    assert counter.count == 1
    assert eng.submit(_batch(6)) == []
    assert len(eng.drain()) == 1
    rt.close()
    assert fm.guard_trips == 0 and fm._snapshot is not None
    events = list(TT.read_events(rt.path))
    rounds = [e for e in events if e["ev"] == "round"]
    assert [e["round"] for e in rounds] == list(range(7))
    for e in rounds:
        assert set(e["metrics"]) == set(TT.METRIC_FIELDS)
        assert e["guard_ok"] is True


def test_heartbeat_parses_with_jax(tmp_path, capfd):
    fm, eng, rt = _engine(tmp_path, ["--guards", "--inject_fault", "1:nan"],
                          drain_every=1)
    eng.heartbeat = TP.Heartbeat(enabled=True)
    for rnd in range(3):
        eng.submit(_batch(rnd))
    rt.close()
    lines = [ln for ln in capfd.readouterr().err.splitlines()
             if ln.startswith("HEARTBEAT")]
    got = [JP.parse_heartbeat(ln) for ln in lines]
    assert [g["round"] for g in got] == [0, 1, 2]
    assert [g["guard_ok"] for g in got] == [True, False, True]
    assert all(g["loss"] > 0 for g in got)
    line = lines[0]
    assert line.split()[2].startswith("loss=") and line.endswith("guard=ok")
    TP.Heartbeat(enabled=True).round(7, epoch=2, loss=1.5, guard_ok=False)
    assert JP.parse_heartbeat(capfd.readouterr().err) == {
        "round": 7, "epoch": 2, "loss": 1.5, "guard_ok": False}


def test_parse_trace_rounds_as_jax():
    assert TP.parse_trace_rounds("10:3,2:5") == \
        JP.parse_trace_rounds("10:3,2:5") == [(2, 5), (10, 3)]
    with pytest.raises(ValueError):
        TP.parse_trace_rounds("x:y")
    with pytest.raises(AssertionError):
        TP.parse_trace_rounds("3:0")


def test_static_window_round_aligned(tmp_path):
    tracer = TP.RoundTracer(str(tmp_path), windows=TP.parse_trace_rounds(
        "2:2"))
    fm, eng, rt = _engine(tmp_path, drain_every=1, tracer=tracer)
    for rnd in range(5):
        eng.submit(_batch(rnd))
    rt.close()
    caps = [e for e in TT.read_events(rt.path)
            if e["ev"] == "trace_captured"]
    assert len(caps) == 1
    assert (caps[0]["round_start"], caps[0]["round_until"]) == (2, 3)
    assert caps[0]["dir"].endswith("trace_round_000002")
    assert os.path.isfile(os.path.join(caps[0]["dir"], "trace.json"))
    assert tracer.captures and tracer.close() is None
    # a window open at the run's end stops at close()
    open_ = TP.RoundTracer(str(tmp_path / "open"),
                           windows=TP.parse_trace_rounds("1:100"))
    open_.on_submit(1)
    cap = open_.close()
    assert cap is not None and cap["round_start"] == 1


def test_defers_while_step_profiler_active(tmp_path):
    prof = TP.StepProfiler(str(tmp_path / "prof"), start_step=0,
                           num_steps=2, enabled=True)
    prof.step(0)
    try:
        tracer = TP.RoundTracer(str(tmp_path),
                                windows=TP.parse_trace_rounds("1:1"))
        tracer.on_submit(1)
        assert tracer._active is None and tracer._pending
        assert not os.path.exists(tmp_path / "trace_round_000001")
    finally:
        prof.close()
    assert os.path.isfile(tmp_path / "prof" / "trace.json")
    tracer.on_submit(2)   # the session is free: the window starts now
    assert tracer._active is not None and tracer._active["start"] == 2
    assert tracer.close() is not None and not tracer._pending
    tracer2 = TP.RoundTracer(str(tmp_path / "t2"))
    assert tracer2.request(1) and not tracer2.request(1)
    tracer2.on_submit(0)
    assert tracer2._active is not None
    prof2 = TP.StepProfiler(str(tmp_path / "prof2"), start_step=0,
                            num_steps=1, enabled=True)
    prof2.step(0)
    assert not prof2._active
    tracer2.close()


def test_injected_fault_alert_reproducible_from_log(tmp_path):
    """A NaN injected at round 7 fires the transmit rule there (the EWMA
    armed after 5 rounds); its trace reaction captures the next rounds;
    ``scripts/obs_report.py`` reads the alert, the capture and the
    quarantined round from the log alone."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import obs_report

    rules = TT.parse_watch_rules(",".join(TT.DEFAULT_WATCH_RULES))
    tracer = TP.RoundTracer(str(tmp_path))
    fm, eng, rt = _engine(tmp_path, ["--guards", "--snapshot_every", "4",
                                     "--max_guard_trips", "5",
                                     "--inject_fault", "7:nan"],
                          drain_every=2, rules=rules, tracer=tracer)
    for rnd in range(12):
        eng.submit(_batch(rnd))
    eng.drain()
    cap = tracer.close()
    if cap is not None:
        rt.event("trace_captured", **cap)
    rt.close()
    assert fm.guard_trips == 1
    events = obs_report.load_events(str(tmp_path))
    s = obs_report.summarize(events)
    assert s["alerts"]["count"] == rt.watch.alerts >= 1
    alert = next(e for e in events if e.get("ev") == "watch_alert"
                 and e["round"] == 7)
    assert alert["metric"] == "transmit_norm"
    assert alert["action"] == "trace" and alert["trace_requested"]
    cap = next(e for e in events if e.get("ev") == "trace_captured")
    assert cap["round_start"] > 7
    assert cap["dir"].endswith(f"trace_round_{cap['round_start']:06d}")
    assert os.path.isfile(os.path.join(cap["dir"], "trace.json"))
    rounds = {e["round"]: e for e in events if e.get("ev") == "round"}
    assert rounds[7]["guard_ok"] is False
    assert rounds[7]["metrics"]["transmit_norm"] == "nan"
