"""The port's health guards (``--guards``, ``--inject_fault``, the ladder
of ``FedModel._note_guard``) against the JAX package's on the CPU,
mirroring ``tests/test_fault_tolerance.py``: the same tiny model (flax's
``nn.Dense(4, use_bias=False)`` on 3 inputs, and the port's copy of it
from the same initial weights), the same batches, the engine draining
every round (the ladder runs at the drain), a run event log on each side.

For the same ``--inject_fault`` spec both packages quarantine the same
rounds, roll back at the same round and abort at the same round; the
port's quarantined round leaves weights, server state and client rows
bit-equal to the state before it; and the two event logs hold the same
event kinds in the same order with the same field names, the guard
events' fields equal, the rounds' verdicts equal and their metric
vectors equal (NaN positions and the counts exactly; the norms to
``rtol=1e-4``: the two packages' client gradients differ in float32
order). Guards on a healthy run change nothing (bit-identical to off).
The fused epilogue composes with the guard, as in JAX's
``test_fused_epilogue_path`` (its Pallas interpreter; the port's plain
version on the CPU).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu import telemetry as JT  # noqa: E402
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated import LambdaLR as JLambdaLR  # noqa: E402
from commefficient_tpu.federated.engine import PipelinedRoundEngine as JEngine  # noqa: E402
from commefficient_torch import telemetry as TT  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR  # noqa: E402
from commefficient_torch.federated.engine import PipelinedRoundEngine  # noqa: E402
from commefficient_torch.federated.rounds import ClientStates  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

ROUNDS = 7
BASE = ["--k", "2", "--num_workers", "2", "--weight_decay", "0",
        "--local_momentum", "0", "--num_clients", "4", "--num_devices", "1",
        "--seed", "0", "--dataset_name", "CIFAR10", "--num_epochs", "2",
        "--num_cols", "16", "--num_rows", "2", "--num_blocks", "1",
        "--guards", "--no_watch"]
MODE_ARGV = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--virtual_momentum", "0.9", "--local_batch_size", "2"],
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--virtual_momentum", "0.9", "--local_batch_size", "2"],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--virtual_momentum", "0", "--local_batch_size", "-1"],
}
# run -> (mode, extra flags); the injected specs of
# tests/test_fault_tolerance.py, and its ladder
RUNS = {
    "sketch-nan": ("sketch", ["--inject_fault", "2:nan"]),
    "sketch-inf": ("sketch", ["--inject_fault", "2:inf"]),
    "true_topk-nan": ("true_topk", ["--inject_fault", "2:nan"]),
    "fedavg-inf": ("fedavg", ["--inject_fault", "2:inf"]),
    "fused-nan": ("sketch", ["--inject_fault", "2:nan",
                             "--fused_epilogue"]),
    "ladder": ("sketch", ["--inject_fault", "3:nan,4:inf,5:nan",
                          "--snapshot_every", "1", "--max_guard_trips",
                          "3"]),
}
METRIC_EXACT = ("update_nnz", "guard_ok") + tuple(
    f for f in JT.METRIC_FIELDS if "_hist_" in f)


class TinyModel(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        return nn.Dense(4, use_bias=False)(x)


def _j_loss(params, model_state, batch, rng, train):
    pred = TinyModel().apply({"params": params}, batch["inputs"])
    err = pred - batch["targets"]
    mask = batch["mask"]
    return jnp.sum(jnp.square(err).mean(-1) * mask), (), jnp.sum(mask), \
        model_state


class TorchTiny(torch.nn.Module):
    """The port's copy of ``TinyModel``: one ``Dense_0/kernel`` leaf."""

    def __init__(self):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.zeros(4, 3))

    def jax_param_path(self, name):
        return ("Dense_0", "kernel")

    def jax_param_kind(self, name):
        return "dense"

    def initial_model_state(self):
        return {}


def _t_loss(params, model_state, batch, rng, train):
    pred = batch["inputs"] @ params["kernel"].T
    err = pred - batch["targets"]
    mask = batch["mask"]
    return torch.sum(torch.square(err).mean(-1) * mask), (), \
        torch.sum(mask), model_state


def _host_batch(rnd):
    ids = [rnd % 4, (rnd + 1) % 4]
    rs = np.random.RandomState(rnd)
    return {"inputs": rs.randn(2, 2, 3).astype(np.float32),
            "targets": rs.randn(2, 2, 4).astype(np.float32),
            "mask": np.ones((2, 2), np.float32),
            "client_ids": np.asarray(ids, np.int32),
            "worker_mask": np.ones(2, np.float32)}


def _events(path):
    return [e for e in JT.read_events(path) if e["ev"] != "run_start"]


def _flat(fm, jax_side):
    w = fm.ps_weights
    if fm.layout is not None:
        w = fm.layout.unchunk(w)
    return np.array(w) if jax_side else w.numpy().copy()


def _run_jax(argv, path):
    args = j_parse(argv=argv)
    fm = JFedModel(TinyModel(), _j_loss, args, input_shape=(3,))
    opt = JFedOptimizer(fm, args)
    fm.telemetry = JT.RunTelemetry(path, run_info={},
                                   schema=JT.metric_schema(True))
    eng = JEngine(fm, opt, JLambdaLR(opt, lambda s: 0.5), window=2,
                  drain_every=1)
    flat0 = np.asarray(ravel_pytree(fm.params)[0])
    return fm, eng, flat0


def _run_port(argv, path, flat0):
    args = t_parse(argv=argv + ["--device", "cpu"])
    model = TorchTiny()
    fm = FedModel(model, _t_loss, args, num_clients=4, device="cpu",
                  init_params=flat_from_jax(flat0, ParamLayout(model)))
    opt = FedOptimizer(fm, args)
    fm.telemetry = TT.RunTelemetry(path, run_info={},
                                   schema=TT.metric_schema(True))
    eng = PipelinedRoundEngine(fm, opt, LambdaLR(opt, lambda s: 0.5),
                               window=2, drain_every=1)
    return fm, opt, eng


def _port_state(fm, opt):
    return [x.clone() for x in (fm.ps_weights, *opt.server_state,
                                *fm.client_states) if x is not None]


def _drive(fm, eng, flat_of, state_of=None):
    """ROUNDS submits; per round the weights after it (and, with
    ``state_of``, whether the full state kept its bits); the round a
    RuntimeError stopped at, and its message."""
    traj, kept, stop = [], [], None
    for rnd in range(ROUNDS):
        before = state_of() if state_of else None
        try:
            eng.submit(_host_batch(rnd))
        except RuntimeError as e:
            stop = (rnd, str(e))
            break
        traj.append(flat_of())
        if state_of:
            kept.append(all(
                np.array_equal(a.numpy().view(np.uint32),
                               b.numpy().view(np.uint32))
                for a, b in zip(before, state_of())))
    fm.telemetry.close()
    return traj, kept, stop


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run of ``RUNS`` through both packages, and the port with
    guards off for the healthy-run identity."""
    tmp = tmp_path_factory.mktemp("guards")
    out = {}
    old = os.environ.get("COMMEFFICIENT_FUSED_EPILOGUE")
    for name, (mode, extra) in RUNS.items():
        argv = BASE + MODE_ARGV[mode] + extra
        if "--fused_epilogue" in extra:
            # JAX's epilogue kernel through the Pallas interpreter, as
            # tests/test_fault_tolerance.py runs it on the CPU
            os.environ["COMMEFFICIENT_FUSED_EPILOGUE"] = "interpret"
        try:
            jfm, jeng, flat0 = _run_jax(argv, str(tmp / f"j_{name}.jsonl"))
            jtraj, _, jstop = _drive(jfm, jeng, lambda: _flat(jfm, True))
        finally:
            if old is None:
                os.environ.pop("COMMEFFICIENT_FUSED_EPILOGUE", None)
            else:
                os.environ["COMMEFFICIENT_FUSED_EPILOGUE"] = old
        tfm, topt, teng = _run_port(argv, str(tmp / f"t_{name}.jsonl"),
                                    flat0)
        ttraj, kept, tstop = _drive(tfm, teng, lambda: _flat(tfm, False),
                                    lambda: _port_state(tfm, topt))
        out[name] = dict(
            jtrips=jfm.guard_trips, ttrips=tfm.guard_trips, jtraj=jtraj,
            ttraj=ttraj, kept=kept, jstop=jstop, tstop=tstop, flat0=flat0,
            tfm=tfm, topt=topt,
            jev=_events(str(tmp / f"j_{name}.jsonl")),
            tev=_events(str(tmp / f"t_{name}.jsonl")))
    return out


def _quarantined(traj, flat0):
    prev, out = flat0, []
    for rnd, w in enumerate(traj):
        if np.array_equal(w, prev):
            out.append(rnd)
        prev = w
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_quarantine_as_jax(name, runs):
    r = runs[name]
    assert r["ttrips"] == r["jtrips"] >= 1
    jq = _quarantined(r["jtraj"], r["flat0"])
    tq = _quarantined(r["ttraj"], r["flat0"])
    assert tq == jq, (tq, jq)
    # the port's quarantined rounds keep every bit of the state
    assert [i for i, k in enumerate(r["kept"]) if k] == tq
    for w in r["ttraj"]:
        assert np.all(np.isfinite(w))
    if name != "ladder":
        np.testing.assert_allclose(r["ttraj"][-1], r["jtraj"][-1],
                                   rtol=1e-4, atol=1e-6)
        for arr in (*r["topt"].server_state, *r["tfm"].client_states):
            if arr is not None:
                assert torch.isfinite(arr).all()


def test_same_rollback_and_abort_as_jax(runs):
    r = runs["ladder"]
    assert r["tstop"] is not None and r["jstop"] is not None
    assert r["tstop"][0] == r["jstop"][0] == 5
    assert r["tstop"][1] == r["jstop"][1]
    assert "health guard tripped 3 consecutive rounds" in r["tstop"][1]
    # rounds 3 and 4 kept the state (the rollback at 4 restored the
    # snapshot of round 2, which round 3 had kept)
    assert r["kept"][3:5] == [True, True]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_event_log_as_jax(name, runs):
    r = runs[name]
    jev, tev = r["jev"], r["tev"]
    assert [e["ev"] for e in tev] == [e["ev"] for e in jev]
    for je, te in zip(jev, tev):
        assert set(te) == set(je), (je["ev"], set(te) ^ set(je))
        if je["ev"] in ("guard_trip", "rollback", "guard_fatal"):
            assert {k: v for k, v in te.items() if k != "t"} == \
                {k: v for k, v in je.items() if k != "t"}
        if je["ev"] != "round":
            continue
        assert te["round"] == je["round"]
        assert te["guard_ok"] == je["guard_ok"]
        assert te["cohort"] == je["cohort"]
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5)
        for k, jv in je["metrics"].items():
            tv = te["metrics"][k]
            if isinstance(jv, str) or isinstance(tv, str):
                assert tv == jv, (je["round"], k, tv, jv)
            elif k in METRIC_EXACT:
                assert tv == jv, (je["round"], k, tv, jv)
            else:
                np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-7,
                                           err_msg=f"{je['round']} {k}")


def test_guards_change_nothing_on_a_healthy_run(tmp_path, runs):
    argv = BASE + MODE_ARGV["sketch"]
    flat0 = runs["sketch-nan"]["flat0"]
    out = []
    for extra in ([], ["--no_telemetry"]):
        a = [x for x in argv if x != "--guards"] if extra else argv
        fm, opt, eng = _run_port(a + extra, str(tmp_path / f"{len(out)}"),
                                 flat0)
        traj, _, _ = _drive(fm, eng, lambda: _flat(fm, False))
        assert fm.guard_trips == 0
        out.append((traj, opt.server_state))
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    for a, b in zip(out[0][1], out[1][1]):
        if a is not None:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_snapshot_is_a_clone_and_survives_rounds(runs):
    """The snapshot holds clones: rounds after it (which replace the
    weights and update client rows in place) leave it as taken, and a
    restore hands out fresh clones, so a later rollback finds it
    intact."""
    argv = BASE + MODE_ARGV["true_topk"] + ["--snapshot_every", "2",
                                            "--local_momentum", "0.9"]
    args = t_parse(argv=argv + ["--device", "cpu"])
    model = TorchTiny()
    fm = FedModel(model, _t_loss, args, num_clients=4, device="cpu",
                  init_params=flat_from_jax(runs["sketch-nan"]["flat0"],
                                            ParamLayout(model)))
    opt = FedOptimizer(fm, args)
    eng = PipelinedRoundEngine(fm, opt, LambdaLR(opt, lambda s: 0.5),
                               window=2, drain_every=1)
    for rnd in range(2):
        eng.submit(_host_batch(rnd))
    assert fm._snapshot is not None
    ps, ss, ms = fm._snapshot
    taken = [x.clone() for x in (ps, *ss) if x is not None]
    assert fm.client_states.velocities is not None
    eng.submit(_host_batch(2))
    for a, b in zip(taken, [x for x in (ps, *ss) if x is not None]):
        assert torch.equal(a, b)
    fm._restore_snapshot()
    assert fm.ps_weights is not ps and torch.equal(fm.ps_weights, ps)
    assert isinstance(fm.client_states, ClientStates)
