"""The port's other server modes and per-client worker path end to end
against the JAX package on the CPU: three rounds of ``FedModel`` /
``FedOptimizer`` from the same weights and batches (the JAX side on one
device) for each config, and the byte accounting of every mode.

Configs (BASELINE.md configs 1 and 2, and the per-client recipes):

- c1: ``uncompressed``, 1 worker, virtual momentum (the fused client phase);
- c2: ``true_topk``, virtual error and momentum (the fused client phase);
- local-topk: local error and local momentum, a top-k per client;
- sketch-local: local error and momentum in sketch space, ``(r, c_pad)``
  client tables;
- fedavg: 2 local epochs in chunks of 2 with lr decay;
- topk-down: sketch mode with ``--topk_down`` stale client weights;
- true_topk-local-momentum: the server masks the clients' velocities at
  the global top-k;
- uncompressed-dp: worker DP (clip, zero noise) on the per-client path;
- sketch-max_grad_norm: per-client tables clipped by their
  ``l2estimate``;
- sketch-test: ``--test``'s all-ones transmit.

Round 1 has a short client (its second fedavg chunk is all padding) and,
with more than one worker, a padded slot (``worker_mask`` 0, client id 0,
which round 0 updated); client 1 takes part in all three rounds.

Tolerances: per-client gradients come from PyTorch's CPU convolutions and
XLA's, which sum in another order, and XLA contracts ``g + m * v`` into a
fused multiply-add inside its jitted steps, so losses agree to
``rtol=1e-4``, weights and client-state rows to ``rtol=1e-4,
atol=1e-6``. Coordinates at the top-k cut can swap, so the
coordinates a round moves must overlap by at least 0.99. Under
``--topk_down`` the clients' reconstruction takes a top-k of ``ps -
stale`` differences that round differently in the two frameworks, so a
swap there changes the weights a client trains on and compounds from
round to round: each round of that config starts from JAX's weights,
server state and stale weights, and a weight outside the tolerance must
be one a round moved, at most 1% of the round's moved set. Download counts
agree to ``rtol=0.01``; uploads exactly. Rows of clients that are not in
a round are unchanged bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.federated.rounds import ClientStates  # noqa: E402
from commefficient_torch.federated.server import ServerState  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
B, NCLIENTS, LR = 4, 8, 0.1
COMMON = ["--k", "500", "--num_cols", "2048", "--num_rows", "3",
          "--num_blocks", "2", "--num_devices", "1",
          "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
          "--seed", "0", "--no_telemetry"]
CONFIGS = {
    "c1": (1, ["--mode", "uncompressed", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.9",
               "--local_batch_size", str(B)]),
    "c2": (4, ["--mode", "true_topk", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.9",
               "--local_batch_size", str(B)]),
    "local-topk": (4, ["--mode", "local_topk", "--error_type", "local",
                       "--local_momentum", "0.9",
                       "--local_batch_size", str(B)]),
    "sketch-local": (4, ["--mode", "sketch", "--error_type", "local",
                         "--local_momentum", "0.9", "--virtual_momentum", "0",
                         "--local_batch_size", str(B)]),
    "fedavg": (4, ["--mode", "fedavg", "--error_type", "none",
                   "--local_momentum", "0", "--local_batch_size", "-1",
                   "--fedavg_batch_size", "2", "--num_fedavg_epochs", "2",
                   "--fedavg_lr_decay", "0.9"]),
    "topk-down": (4, ["--mode", "sketch", "--error_type", "virtual",
                      "--local_momentum", "0", "--virtual_momentum", "0.9",
                      "--local_batch_size", str(B), "--topk_down"]),
    "true_topk-local-momentum": (4, ["--mode", "true_topk",
                                     "--error_type", "virtual",
                                     "--local_momentum", "0.9",
                                     "--local_batch_size", str(B)]),
    "uncompressed-dp": (4, ["--mode", "uncompressed", "--error_type", "none",
                            "--local_momentum", "0", "--dp",
                            "--l2_norm_clip", "0.05",
                            "--local_batch_size", str(B)]),
    "sketch-max_grad_norm": (4, ["--mode", "sketch", "--error_type",
                                 "virtual", "--local_momentum", "0",
                                 "--virtual_momentum", "0.9",
                                 "--max_grad_norm", "0.05",
                                 "--local_batch_size", str(B)]),
    "sketch-test": (4, ["--mode", "sketch", "--error_type", "virtual",
                        "--local_momentum", "0", "--virtual_momentum", "0.9",
                        "--local_batch_size", str(B), "--test"]),
}
# the slots' client ids by round: slot 3 of round 1 is padding (id 0)
IDS = [[0, 1, 2, 3], [4, 1, 5, 0], [1, 6, 2, 7]]


def _batch(rnd, W):
    rng = np.random.RandomState(100 + rnd)
    mask = np.ones((W, B), np.float32)
    wmask = np.ones(W, np.float32)
    if rnd == 1:
        mask[min(1, W - 1), 2:] = 0.0   # a short client
        if W > 1:
            mask[W - 1] = 0.0
            wmask[W - 1] = 0.0
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": mask, "client_ids": np.array(IDS[rnd][:W], np.int32),
            "worker_mask": wmask}


def _states(cs, to_np):
    return {name: to_np(getattr(cs, name)).reshape(NCLIENTS, -1)
            for name in ("velocities", "errors", "weights")
            if getattr(cs, name) is not None}


def _run(name):
    W, extra = CONFIGS[name]
    argv = COMMON + ["--num_workers", str(W)] + extra
    jargs = j_parse(argv=argv)
    jm = JResNet9(channels=TINY)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    assert jfm.mesh is None or jfm.mesh.devices.size == 1
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])

    targs = t_parse(argv=argv + ["--device", "cpu"])
    tm = ResNet9(channels=TINY)
    layout = ParamLayout(tm)
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=NCLIENTS,
                   init_params=flat_from_jax(flat0, layout), device="cpu")
    topt = FedOptimizer(tfm, targs)
    topt.set_lr_factor(LR)

    rounds = []
    for rnd in range(3):
        b = _batch(rnd, W)
        before = _states(tfm.client_states, lambda t: t.numpy().copy())
        jres = jfm(b)
        jopt.step()
        tres = tfm(b)
        topt.step()
        rounds.append(dict(
            batch=b, jres=jres, tres=tres, before=before,
            jw=np.asarray(ravel_pytree(jfm.params)[0]),
            tw=layout.flatten(tfm.params).numpy().copy(),
            jstates=_states(jfm.client_states, np.asarray),
            tstates=_states(tfm.client_states, lambda t: t.numpy().copy())))
        if name == "topk-down":
            # each round starts from JAX's state, so that a swap at a
            # top-k cut does not compound (see the module docstring)
            tfm.ps_weights = torch.from_numpy(rounds[-1]["jw"].copy())
            topt.server_state = ServerState(*(
                torch.from_numpy(np.array(x)) for x in jopt.server_state[:2]))
            tfm.client_states = ClientStates(None, None, torch.from_numpy(
                np.array(jfm.client_states.weights)))
    return flat0, rounds, tfm


_CACHE = {}


@pytest.fixture(params=list(CONFIGS))
def run(request):
    if request.param not in _CACHE:
        _CACHE[request.param] = _run(request.param)
    return request.param, _CACHE[request.param]


def test_losses_metrics_and_bytes(run):
    name, (_, rounds, _) = run
    for r in rounds:
        (jl, ja, jd, ju), (tl, ta, td, tu) = r["jres"], r["tres"]
        assert tl.shape == jl.shape == (int(r["batch"]["worker_mask"].sum()),)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_allclose(td, jd, rtol=0.01)


def test_weights_and_selected_sets(run):
    name, (flat0, rounds, _) = run
    jprev = tprev = flat0
    for rnd, r in enumerate(rounds):
        jw, tw = r["jw"], r["tw"]
        jsel = np.flatnonzero(jw != jprev)
        tsel = np.flatnonzero(tw != tprev)
        assert len(jsel) >= 500 and len(tsel) >= 500, (rnd, len(jsel))
        both = len(np.intersect1d(jsel, tsel))
        assert both / max(len(jsel), len(tsel)) >= 0.99, (rnd, both)
        off = ~np.isclose(tw, jw, rtol=1e-4, atol=1e-6)
        if name == "topk-down":
            moved = np.union1d(jsel, tsel)
            assert off.sum() <= max(1, len(moved) // 100), (rnd, off.sum())
            assert np.isin(np.flatnonzero(off), moved).all(), rnd
            # the next round starts from JAX's weights
            tw = jw
        else:
            assert not off.any(), (rnd, np.abs(tw - jw).max())
        jprev, tprev = jw, tw


def test_client_state_rows(run):
    """The rows track JAX's, and a client not in the round (or only in a
    padded slot) keeps its rows bit for bit."""
    name, (_, rounds, tfm) = run
    wcfg = tfm.worker_config
    want = {n for n, on in (("velocities", wcfg.has_velocity),
                            ("errors", wcfg.has_error),
                            ("weights", wcfg.do_topk_down)) if on}
    assert set(rounds[0]["tstates"]) == set(rounds[0]["jstates"]) == want
    for rnd, r in enumerate(rounds):
        b = r["batch"]
        real = set(b["client_ids"][b["worker_mask"] > 0].tolist())
        for n in want:
            t, j, before = r["tstates"][n], r["jstates"][n], r["before"][n]
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)
            for c in range(NCLIENTS):
                if c not in real:
                    np.testing.assert_array_equal(t[c], before[c])
                elif n != "weights" or rnd > 0:
                    assert (t[c] != before[c]).any(), (n, rnd, c)


# ---- byte accounting of each mode against the JAX package ------------------

MODE_ARGS = {
    "uncompressed": ["--mode", "uncompressed", "--error_type", "none"],
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--local_momentum", "0"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local"],
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--local_momentum", "0"],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--local_momentum", "0"],
}


@pytest.mark.parametrize("regime", ["since-last", "since-init"])
@pytest.mark.parametrize("mode", list(MODE_ARGS))
def test_byte_accounting_per_mode(mode, regime):
    """Upload per mode (the gradient size, k, or the padded table) and
    download in either regime, from the same weight snapshots, equal to
    the JAX package's, in the resident layout of the mode."""
    lbs = "-1" if (mode == "fedavg" or regime == "since-init") else str(B)
    epochs = "1" if regime == "since-init" else "3"
    argv = COMMON + MODE_ARGS[mode] + ["--num_workers", "2",
                                       "--local_batch_size", lbs,
                                       "--num_epochs", epochs]
    jargs = j_parse(argv=argv)
    jm = JResNet9(channels=TINY)
    jfm = JFedModel(jm, j_losses(jm)[0], jargs, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    targs = t_parse(argv=argv + ["--device", "cpu"])
    tm = ResNet9(channels=TINY)
    tfm = FedModel(tm, t_losses(tm)[0], targs, num_clients=NCLIENTS,
                   device="cpu")
    d = tfm.grad_size
    assert (tfm.layout is not None) == (mode == "sketch")
    assert (tfm.sketch is not None) == (mode == "sketch")
    rng = np.random.RandomState(len(mode))
    w = rng.randn(d).astype(np.float32)
    jfm.ps_weights = jnp.asarray(w) if jfm.layout is None \
        else jfm.layout.chunk(jnp.asarray(w))
    jfm._prev_ps = jfm.ps_weights
    tfm.ps_weights = torch.from_numpy(w) if tfm.layout is None \
        else tfm.layout.chunk(torch.from_numpy(w))
    tfm._prev_ps = tfm.ps_weights
    for rnd in range(4):
        moved = rng.choice(d, 300 * (rnd + 1), replace=False)
        w = w.copy()
        w[moved] += 1.0
        jfm.ps_weights = jnp.asarray(w) if jfm.layout is None \
            else jfm.layout.chunk(jnp.asarray(w))
        tfm.ps_weights = torch.from_numpy(w) if tfm.layout is None \
            else tfm.layout.chunk(torch.from_numpy(w))
        part = np.sort(rng.choice(NCLIENTS, 3, replace=False))
        jdown, jup = jfm._account_bytes(part)
        tdev, tup = tfm._account_bytes_deferred(part)
        tdown = np.zeros(NCLIENTS)
        tdown[part] = 4.0 * tdev.numpy()
        np.testing.assert_array_equal(tup, jup)
        np.testing.assert_array_equal(tdown, jdown)
    per = {"uncompressed": d, "true_topk": d, "fedavg": d,
           "local_topk": 500,
           "sketch": 3 * 2048}[mode]
    assert tup[part].tolist() == [4 * per] * len(part)


@pytest.mark.parametrize("flags", [
    ["--mode", "true_topk", "--error_type", "virtual",
     "--local_momentum", "0", "--virtual_momentum", "0.9"],
    ["--mode", "local_topk", "--error_type", "local"],
    ["--mode", "fedavg", "--error_type", "none", "--local_momentum", "0",
     "--local_batch_size", "-1", "--fedavg_batch_size", "4"],
], ids=["true_topk", "local_topk", "fedavg"])
def test_cv_train_main_cpu_modes(tmp_path, monkeypatch, flags):
    """The CLI runs the other modes on the CPU with ``--device cpu``."""
    from commefficient_torch import cv_train

    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "8")
    summary = cv_train.main([
        "--dataset_name", "CIFAR10", "--dataset_dir", str(tmp_path / "d"),
        "--num_epochs", "1", "--num_workers", "2", "--local_batch_size", "4",
        "--valid_batch_size", "8", "--iid", "--num_clients", "4",
        "--k", "500", "--lr_scale", "0.01", "--pivot_epoch", "0.5",
        "--seed", "0", "--device", "cpu"] + flags)
    # (the per-epoch MiB columns round these modes' small uploads to 0)
    assert summary["epoch"] == 1
    assert np.isfinite(summary["train_loss"])
    assert np.isfinite(summary["test_acc"])
