"""The port's observability plane (``commefficient_torch/telemetry.py``)
and its CLI surface against the JAX package's on the CPU, mirroring
``tests/test_telemetry.py`` and ``tests/test_watch.py``.

- The log-magnitude histogram equals JAX's ``log_magnitude_histogram``
  on seeded data and at the float32 neighbours of the decade edges 1, 100
  and 1e4, and goes on counting where JAX's float32 scatter-add stops
  (2^24 in a bin).
- The metric vector of the port's server step equals JAX's
  ``device_round_metrics`` on the same planes (the transmit the server
  consumed, the update, the new weights and state) in all five modes and
  the fused epilogue, with histograms on and off: the counts,
  update_nnz, topk_threshold, guard_ok and the largest magnitudes
  exactly, the norms to ``rtol=1e-5`` (float32 summation order). The
  same on 2 and 4 gloo ranks under ``--server_shard`` (one spawn;
  integer transmits at n = 4), where every rank's vector is equal, the
  verdict is AND-ed over the ranks, and rank 0's poisoned partial trips
  every rank. A watch rule's checkpoint reaction under ``cv_train`` on 2
  ranks saves on both ranks at the same drain.
- Trajectories are bit-identical with telemetry on and off, and with
  guards on (no trip) and off.
- A port ``cv_train`` run's ``telemetry.jsonl`` renders with
  ``scripts/obs_report.py`` (unedited, in a subprocess); ``read_events``
  stops at a torn tail.
- Every flag of the JAX package's parser parses in the port with its
  default, and setting it works, is ignored as JAX ignores it, or raises
  ``NotImplementedError`` naming its ROADMAP item (the flag walk).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu import telemetry as JT  # noqa: E402
from commefficient_tpu.config import build_parser as j_build_parser  # noqa: E402
from commefficient_tpu.federated.server import ServerState as JState  # noqa: E402
from commefficient_torch import telemetry as TT  # noqa: E402
from commefficient_torch.config import build_parser as t_build_parser  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from tests.torch_dist_ranks import obs_server_step, start_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORM_RTOL = 1e-5
EXACT = ("transmit_max_abs", "update_nnz", "topk_threshold", "ps_max_abs",
         "guard_ok") + tuple(f for f in JT.METRIC_FIELDS if "_hist_" in f)


def _j_hist(x):
    return np.asarray(JT.log_magnitude_histogram(jnp.asarray(x)))


def _t_hist(x):
    return TT.log_magnitude_histogram(torch.from_numpy(x)).numpy()


# ---- the histogram ---------------------------------------------------------

def test_histogram_seeded_data_against_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(20000) * 10 ** rs.uniform(-14, 6, 20000)).astype(
        np.float32)
    x[::17] = 0.0
    x[5:8] = [np.nan, np.inf, -np.inf]
    got = _t_hist(x)
    np.testing.assert_array_equal(got, _j_hist(x))
    assert got.sum() == np.count_nonzero(x)
    # JAX's edge conventions (tests/test_watch.py): zero excluded, under-
    # and overflow clamped, inf and NaN in the last bin
    e = np.array([0.0, 1e-13, 1e-11, 0.5, 3.0, 1e5, np.inf, np.nan],
                 np.float32)
    np.testing.assert_array_equal(_t_hist(e), [2, 0, 0, 0, 0, 1, 1, 3])


@pytest.mark.parametrize("edge", [1.0, 100.0, 1e4])
def test_histogram_at_representable_edges(edge):
    """Each edge, its negative and its float32 neighbours land where
    JAX's bins put them (no disagreement of log10 by an ulp was found at
    these edges)."""
    e = np.float32(edge)
    x = np.array([e, -e, np.nextafter(e, np.float32(0)),
                  np.nextafter(e, np.float32(np.inf))], np.float32)
    for v in x:
        np.testing.assert_array_equal(_t_hist(v[None]), _j_hist(v[None]),
                                      err_msg=repr(v))


def test_histogram_counts_past_jax_limit():
    """2^24 + 4,096 ones: JAX's float32 scatter-add stops at 16,777,216 in
    their bin, the port counts in int64 and reports 16,781,312 (exact in
    float32). The port does not mirror the limit: the count is an
    observation no state depends on (ROADMAP queue 3)."""
    ones = np.ones(2 ** 24 + 4096, np.float32)
    assert _j_hist(ones)[6] == 16_777_216
    assert _t_hist(ones)[6] == 16_781_312


def test_schema_versions():
    assert TT.METRIC_FIELDS == JT.METRIC_FIELDS
    assert TT.metric_schema(False) == JT.metric_schema(False)
    assert TT.N_SCALAR_FIELDS == JT.N_SCALAR_FIELDS == 12
    assert (TT.HIST_BINS, TT.HIST_LO, TT.HIST_STEP) == \
        (JT.HIST_BINS, JT.HIST_LO, JT.HIST_STEP)


# ---- the metric vector against device_round_metrics -----------------------

MODE_ARGV = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--virtual_momentum", "0.9"],
    "sketch-fused": ["--mode", "sketch", "--error_type", "virtual",
                     "--virtual_momentum", "0.9", "--fused_epilogue"],
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--virtual_momentum", "0.9"],
    "uncompressed": ["--mode", "uncompressed", "--error_type", "none",
                     "--virtual_momentum", "0.5"],
    "local_topk": ["--mode", "local_topk", "--error_type", "none",
                   "--virtual_momentum", "0.5"],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--virtual_momentum", "0.5", "--local_batch_size", "-1"],
}
D_SKETCH, C, R, K, D_DENSE = 1100, 100, 3, 50, 1001


def _case(mode, rs, n=1, hists=True, integer=False, poison=False,
          plan=""):
    sketch = mode.startswith("sketch")
    d = D_SKETCH if sketch else D_DENSE
    shape = (R, 128) if sketch else (d,)
    if integer:
        tr = rs.randint(-50, 51, (n,) + shape).astype(np.float32)
    else:
        tr = (rs.randn(n, *shape) * 10 ** rs.uniform(-9, 2, (n,) + shape)
              ).astype(np.float32)
        tr[:, ::7] = 0.0
    argv = MODE_ARGV[mode] + [
        "--local_momentum", "0", "--k", str(K), "--num_cols", str(C),
        "--num_rows", str(R), "--num_blocks", "1", "--num_workers", "2",
        "--seed", "5", "--guards"]
    if not hists:
        argv.append("--no_telemetry_hist")
    if n > 1:
        argv.append("--server_shard")
    if plan:
        argv += ["--collective_plan", plan]
    st_shape = (R, 128) if sketch else (d,)
    return dict(mode=mode, d=d, argv=argv, transmits=tr, poison=poison,
                hists=hists, ps0=rs.randn(d).astype(np.float32),
                vel0=rs.randn(*st_shape).astype(np.float32),
                err0=(rs.randn(*st_shape).astype(np.float32)
                      if "virtual" in argv else
                      np.zeros(st_shape, np.float32)),
                lr=1.0 if mode == "fedavg" else 0.5, count=7.0)


def _jax_metrics(c, outs, sharded):
    """JAX's ``device_round_metrics`` on the planes the ranks' step used:
    the stacked per-rank transmits under ``--server_shard`` (JAX's view),
    the replicated update and weights, the global state (the ranks'
    slices joined in the dense sharded modes) and the stacked carries."""
    o = outs[0]
    if sharded:
        transmit = np.stack([x["transmit"] for x in outs])
        dense = not c["mode"].startswith("sketch")
        vel = np.concatenate([x["vel"] for x in outs]) if dense else o["vel"]
        err = np.concatenate([x["err"] for x in outs]) if dense else o["err"]
        qres = (None if o["qres"] is None
                else jnp.asarray(np.stack([x["qres"] for x in outs])))
        dres = (None if o["dres"] is None
                else jnp.asarray(np.stack([x["dres"] for x in outs])))
    else:
        transmit, vel, err, qres, dres = (o["transmit"], o["vel"], o["err"],
                                          None, None)
    state = JState(velocity=jnp.asarray(vel), error=jnp.asarray(err),
                   qres=qres, dres=dres)
    return np.asarray(JT.device_round_metrics(
        jnp.asarray(transmit), jnp.asarray(o["update"]),
        jnp.asarray(o["new_ps"]), state, guard_ok=jnp.asarray(o["ok"]),
        hists=c["hists"]))


def _check_vector(got, want, hists, what):
    names = TT.metric_schema(hists)
    assert got.shape == want.shape == (len(names),), what
    for i, name in enumerate(names):
        if name in EXACT:
            np.testing.assert_array_equal(got[i], want[i],
                                          err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=NORM_RTOL,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("hists", [True, False], ids=["hists", "nohists"])
@pytest.mark.parametrize("mode", sorted(MODE_ARGV))
def test_metric_vector_against_jax(mode, hists):
    c = _case(mode, np.random.RandomState(len(mode)), hists=hists)
    out = obs_server_step(c)
    assert out["ok"]
    _check_vector(out["tel"], _jax_metrics(c, [out], False), hists, mode)


def test_poisoned_replicated_step_is_quarantined():
    """--inject_fault's NaN in the reduced transmit: the verdict trips,
    the step keeps the weights and state bit for bit, and the vector
    (JAX's on the same planes) shows the non-finite transmit."""
    c = _case("sketch", np.random.RandomState(3), poison=True)
    out = obs_server_step(c)
    assert not out["ok"]
    for a, b in (("new_ps", "ps"), ("vel", "old_vel"), ("err", "old_err")):
        np.testing.assert_array_equal(out[a].view(np.uint32),
                                      out[b].view(np.uint32), err_msg=a)
    got = out["tel"]
    m = dict(zip(TT.METRIC_FIELDS, got))
    assert np.isnan(m["transmit_norm"]) and m["guard_ok"] == 0.0
    want = _jax_metrics(c, [out], False)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(got)
    np.testing.assert_allclose(got[fin], want[fin], rtol=NORM_RTOL)


def _rank_cases(n):
    rs = np.random.RandomState(40 + n)
    if n == 2:
        cases = [_case(m, rs, n) for m in sorted(MODE_ARGV)]
        cases += [_case("sketch", rs, n, hists=False),
                  _case("sketch", rs, n, plan="table=int8,downlink=int4"),
                  _case("uncompressed", rs, n,
                        plan="uplink=int8,downlink=fp8_e4m3"),
                  _case("sketch", rs, n, poison=True),
                  _case("true_topk", rs, n, poison=True)]
    else:
        cases = [_case(m, rs, n, integer=True)
                 for m in ("sketch", "true_topk", "uncompressed")]
        cases.append(_case("uncompressed", rs, n, integer=True,
                           poison=True))
    return cases


def _watch_checkpoint_spec(tmp):
    """``cv_train`` on 2 ranks with a watch rule whose checkpoint reaction
    fires on the first drained round (``loss > 0``; then its cooldown of
    8 rounds outlasts the 5-round epoch) and ``--server_shard``, whose
    save gathers the sharded state over the ranks."""
    argv = ["--device", "cpu", "--dataset_name", "CIFAR10",
            "--dataset_dir", str(tmp / "data"), "--num_epochs", "1",
            "--num_workers", "4", "--local_batch_size", "4", "--iid",
            "--num_clients", "8", "--mode", "true_topk", "--error_type",
            "virtual", "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--k", "500", "--lr_scale", "0.01", "--pivot_epoch", "0.5",
            "--seed", "0", "--server_shard", "--metrics_drain_every", "2",
            "--watch_rules", "loss>0->checkpoint",
            "--checkpoint_path", str(tmp / "ck")]
    env = {"COMMEFFICIENT_TINY_MODEL": "1",
           "COMMEFFICIENT_SYNTHETIC_PER_CLASS": "8",
           "COMMEFFICIENT_RUN_DIR": str(tmp / "run")}
    return {"argv": argv, "env": env}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 ranks: the 2-rank cases on ranks 0-1, then the
    4-rank ones, then ``cv_train``'s watch checkpoint on ranks 0-1."""
    cases = {n: _rank_cases(n) for n in (2, 4)}
    tmp = tmp_path_factory.mktemp("obs_ranks")
    with start_ranks(4, [("body_observability", cases[n], n)
                         for n in (2, 4)]
                     + [("cli_cv_train", _watch_checkpoint_spec(tmp), 2)],
                     tmp) as rk:
        outs = rk.join()
    res = {n: (cases[n], outs[i]) for i, n in enumerate((2, 4))}
    res.update(tmp=tmp, cv_train=outs[2])
    return res


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_metric_vector_and_verdict(n, ranks):
    cases, outs = ranks[n]
    for i, c in enumerate(cases):
        per_rank = [o[i] for o in outs]
        what = f"n={n} {c['mode']} hists={c['hists']} {c['argv'][-1]}"
        # every rank computes the same verdict and vector
        for o in per_rank[1:]:
            assert o["ok"] == per_rank[0]["ok"], what
            np.testing.assert_array_equal(o["tel"], per_rank[0]["tel"],
                                          err_msg=what)
        got = per_rank[0]["tel"]
        want = _jax_metrics(c, per_rank, True)
        if not c["poison"]:
            assert per_rank[0]["ok"], what
            _check_vector(got, want, c["hists"], what)
            continue
        # rank 0's poisoned partial trips every rank, which all keep
        # their weights and state
        assert not per_rank[0]["ok"], what
        assert np.isnan(per_rank[0]["transmit"].reshape(-1)[0])
        assert not np.isnan(per_rank[1]["transmit"]).any()
        for o in per_rank:
            for a, b in (("new_ps", "ps"), ("vel", "old_vel"),
                         ("err", "old_err")):
                np.testing.assert_array_equal(o[a].view(np.uint32),
                                              o[b].view(np.uint32),
                                              err_msg=f"{what} {a}")
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(got)
        np.testing.assert_allclose(got[fin], want[fin], rtol=NORM_RTOL)


def test_watch_checkpoint_on_two_ranks(ranks):
    """The watch engine runs on rank 0 alone, and its checkpoint reaction
    is taken by both ranks at the same drain: the collective save
    completes (no rank waits in it alone), both ranks end with the same
    summary, and the log records the one forced save."""
    outs = [dict(o) for o in ranks["cv_train"]]
    for o in outs:
        o.pop("train_time")
        o.pop("total_time")
    assert outs[0] == outs[1] and np.isfinite(outs[0]["train_loss"])
    tmp = ranks["tmp"]
    assert sorted(os.listdir(tmp / "ck")) == ["run_state_ep1_r2.npz"]
    ev = [e for e in TT.read_events(str(tmp / "run" / "telemetry.jsonl"))
          if e["ev"] == "checkpoint"]
    assert [(e["round_in_epoch"], e.get("forced_by_watch")) for e in ev] \
        == [(2, True)]


# ---- trajectories on and off -----------------------------------------------

TINY = (("prep", 4), ("layer1", 8), ("layer2", 8), ("layer3", 8))
ARGV = ["--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--k", "200", "--num_cols",
        "1024", "--num_rows", "3", "--num_blocks", "2", "--num_workers",
        "2", "--num_clients", "6", "--dataset_name", "CIFAR10",
        "--local_batch_size", "2", "--seed", "0", "--device", "cpu",
        "--num_epochs", "2"]


def _batch(rnd):
    rs = np.random.RandomState(300 + rnd)
    return {"inputs": rs.randn(2, 2, 32, 32, 3).astype(np.float32),
            "targets": rs.randint(0, 10, size=(2, 2)).astype(np.int64),
            "mask": np.ones((2, 2), np.float32),
            "client_ids": rs.choice(6, 2, replace=False).astype(np.int32),
            "worker_mask": np.ones(2, np.float32)}


def _trajectory(extra):
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated.engine import PipelinedRoundEngine
    from commefficient_torch.federated.losses import make_cv_losses
    from commefficient_torch.models import ResNet9

    args = t_parse(argv=ARGV + extra)
    torch.manual_seed(0)
    model = ResNet9(channels=TINY)
    train, val = make_cv_losses(model)
    fm = FedModel(model, train, args, val, num_clients=6, device="cpu")
    opt = FedOptimizer(fm, args)
    from commefficient_torch.federated import LambdaLR

    eng = PipelinedRoundEngine(fm, opt, LambdaLR(opt, lambda s: 0.1),
                               window=2, drain_every=2)
    losses = []
    for rnd in range(4):
        losses += [r.values[0] for r in eng.submit(_batch(rnd))]
    losses += [r.values[0] for r in eng.drain()]
    return fm, opt, losses


def test_trajectories_bit_identical_on_and_off():
    runs = {name: _trajectory(extra) for name, extra in (
        ("off", ["--no_telemetry"]), ("telemetry", []),
        ("guards", ["--no_telemetry", "--guards"]),
        ("both", ["--guards"]))}
    ref_fm, ref_opt, ref_losses = runs.pop("off")
    for name, (fm, opt, losses) in runs.items():
        for a, b in zip(losses, ref_losses):
            np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in ((fm.ps_weights, ref_fm.ps_weights),
                     (opt.server_state.velocity,
                      ref_opt.server_state.velocity),
                     (opt.server_state.error, ref_opt.server_state.error)):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          b.numpy().view(np.uint32),
                                          err_msg=name)
        assert fm.guard_trips == 0


# ---- the event log and obs_report ------------------------------------------

def test_cv_train_log_renders_with_obs_report(tmp_path):
    """A port ``cv_train`` run with the telemetry defaults, ``--guards
    --inject_fault 3:nan --trace_rounds 2:2``: the log holds the JAX
    package's event kinds in its order, renders with the unedited
    ``scripts/obs_report.py`` (the trip, the capture, the histograms),
    and ``read_events`` stops at a torn tail."""
    from commefficient_torch import cv_train

    run = tmp_path / "run"
    env = {"COMMEFFICIENT_RUN_DIR": str(run),
           "COMMEFFICIENT_SYNTHETIC_PER_CLASS": "8",
           "COMMEFFICIENT_TINY_MODEL": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cv_train.main(["--device", "cpu", "--dataset_name", "CIFAR10",
                       "--dataset_dir", str(tmp_path / "d"),
                       "--num_epochs", "1", "--num_workers", "2",
                       "--local_batch_size", "4", "--iid",
                       "--num_clients", "4", "--mode", "sketch",
                       "--error_type", "virtual", "--local_momentum", "0",
                       "--virtual_momentum", "0.9", "--k", "500",
                       "--num_cols", "2048", "--num_rows", "3",
                       "--lr_scale", "0.01", "--pivot_epoch", "0.5",
                       "--seed", "0", "--guards", "--inject_fault", "3:nan",
                       "--trace_rounds", "2:2"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    path = run / "telemetry.jsonl"
    events = list(TT.read_events(str(path)))
    kinds = [e["ev"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    start = events[0]
    assert start["schema"] == list(JT.METRIC_FIELDS)
    assert start["backend"] == "cpu" and start["guards"] is True
    assert start["client_fault"] is None and start["churn"] is None
    assert set(start["ledger"]) == {"client_uplink", "transmit_reduce"}
    trip = kinds.index("guard_trip")
    # JAX's order: the trip lands before its round's line
    assert events[trip + 1] == next(e for e in events
                                    if e.get("round") == 3
                                    and e["ev"] == "round")
    assert events[trip + 1]["guard_ok"] is False
    assert events[trip + 1]["metrics"]["transmit_norm"] == "nan"
    cap = next(e for e in events if e["ev"] == "trace_captured")
    assert (cap["round_start"], cap["round_until"]) == (2, 3)
    assert (run / "trace_round_000002" / "trace.json").is_file()
    assert "epoch" in kinds and "drain" in kinds

    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "obs_report.py"),
         str(run)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "guard TRIP at round 3" in out
    assert "trace captured: rounds 2-3" in out
    assert "magnitude histograms (schema v3)" in out

    with open(path, "a") as f:
        f.write('{"ev": "round", "round": 99, "metr')
    assert len(list(TT.read_events(str(path)))) == len(events)


# ---- the flag walk ---------------------------------------------------------

# flags still unported -> the item their NotImplementedError names
UNPORTED_ITEMS = {
    "--plan_error_budget": "item 5a", "--shard_devices": "item 5a",
    "--seq_parallel": "item 7",
    "--seq_devices": "item 7", "--model_devices": "item 7",
    "--pipeline_devices": "item 7", "--pp_microbatches": "item 7",
    "--n_experts": "item 7", "--expert_devices": "item 7",
    "--moe_dispatch": "item 7", "--moe_capacity_factor": "item 7",
    "--moe_aux_coef": "item 7",
}
# accepted and ignored, as the JAX package ignores them
IGNORED = ("--port", "--share_ps_gpu", "--nan_threshold",
           "--num_results_train", "--num_results_val")
# values that make a flag valid on its own
VALUES = {
    "--reduce_dtype": ["int8", "--server_shard"],
    "--collective_plan": ["float32"], "--inject_fault": ["2:nan"],
    "--watch_rules": ["loss>2"], "--trace_rounds": ["1:1"],
    "--participation": ["0.5"], "--churn": ["join=1"],
    "--inject_client_fault": ["drop=0.1"], "--inject_io_fault": ["eio=0.1"],
    "--device": ["cpu"], "--dataset_name": ["CIFAR10"],
}


def _setting(action):
    """An argv that sets the action's flag to a value other than its
    default."""
    flag = action.option_strings[0]
    if flag in VALUES:
        return [flag] + VALUES[flag]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, next(str(c) for c in action.choices
                           if c != action.default)]
    if action.type is int:
        return [flag, str((action.default or 0) + 1)]
    if action.type is float:
        return [flag, str((action.default or 0.0) + 0.5)]
    return [flag, "x"]


def test_flag_walk():
    """Every flag of the JAX parser: the port's parser takes it with the
    JAX package's dest and default (``--device`` is the documented
    deviation: ``{cuda, cpu}``, default ``cuda``); set, it works, is
    ignored, or raises ``NotImplementedError`` naming its item — never
    argparse's exit 2. ``--rng_impl``'s JAX-only PRNGs raise
    ``ValueError``; its default is accepted."""
    jp, tp = j_build_parser(), t_build_parser()
    walked = 0
    for action in jp._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = action.option_strings[0]
        assert flag in tp._option_string_actions, flag
        mine = tp._option_string_actions[flag]
        assert mine.dest == action.dest, flag
        if flag != "--device":
            assert mine.default == action.default, flag
        argv = _setting(action)
        try:
            args = t_parse(argv=["--device", "cpu"] + argv)
        except NotImplementedError as e:
            assert flag in UNPORTED_ITEMS, (flag, e)
            assert UNPORTED_ITEMS[flag] in str(e), (flag, e)
        except ValueError as e:
            assert flag == "--rng_impl" and "JAX PRNG" in str(e), (flag, e)
        except SystemExit as e:  # argparse's usage error
            raise AssertionError(f"{flag}: exit {e.code}") from None
        else:
            assert flag not in UNPORTED_ITEMS, flag
            # the value JAX's parser gives the same argv
            want = getattr(jp.parse_args(argv), action.dest)
            assert getattr(args, action.dest) == want, flag
        walked += 1
    assert walked >= 100, walked
    for flag in IGNORED:
        assert flag in tp._option_string_actions
    assert t_parse(argv=["--rng_impl", "threefry2x32"]).rng_impl == \
        "threefry2x32"
    d = t_parse(argv=[])
    assert d.telemetry and d.telemetry_hist and d.watch and not d.guards
