"""The port's rounds over a client group of 2 ``gloo`` ranks
(``tests/torch_dist_ranks.py``) against the JAX package's round on a
2-device mesh (``--num_devices 2``), mirroring
``tests/test_sharded_server.py`` and ``tests/test_torch_rounds.py``.

Three FetchSGD rounds of a tiny ResNet9 (the sketch headline config, W =
4 slots, 2 a rank; round 2 has a short client and a padded slot), both
replicated (the transmit all-reduced) and with ``--server_shard``,
agree with JAX's within ``tests/test_torch_rounds.py``'s tolerances:
per-client losses ``rtol=1e-4``, accuracies and upload bytes exactly,
weights ``rtol=1e-4, atol=1e-6``, kept sets overlapping by 0.99 a round
(each side sums the client gradients in its own order). The dense
sharded plane (``true_topk``, the fused client phase, ``d_pad / n``
slices) is held the same way. Within the port: both ranks end with the
same weights bit for bit, and at n = 2 the sharded run equals the
replicated one bit for bit. The participation layer under
``--server_shard`` (faults with late landing, and ``--async_buffer 2``):
each rank folds its partial sums, and the cohort records, the counters
and (within the tolerance above) the weights of 5 rounds equal JAX's on
its 2-device mesh. ``cv_train.main`` and ``gpt2_train.train`` run on 2
ranks as under ``torchrun``. One spawn of 2 ranks runs every
body of this file in turn while the parent runs JAX's rounds.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.federated.participation import (  # noqa: E402
    attach_participation as j_attach_participation,
)
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from tests.torch_dist_ranks import TINY, start_ranks  # noqa: E402

W, B, NCLIENTS, LR = 4, 4, 8, 0.1
SKETCH = ["--mode", "sketch", "--error_type", "virtual",
          "--local_momentum", "0", "--virtual_momentum", "0.9",
          "--k", "500", "--num_cols", "2048", "--num_rows", "3",
          "--num_blocks", "2"]
TOPK = ["--mode", "true_topk", "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", "500"]
COMMON = ["--num_workers", str(W), "--num_devices", "2",
          "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
          "--local_batch_size", str(B), "--seed", "0"]


def _batch(rnd):
    rng = np.random.RandomState(100 + rnd)
    mask = np.ones((W, B), np.float32)
    wmask = np.ones(W, np.float32)
    if rnd == 1:  # a short client and a padded slot
        mask[1, 3] = 0.0
        mask[3] = 0.0
        wmask[3] = 0.0
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": mask,
            "client_ids": rng.choice(NCLIENTS, W, replace=False)
            .astype(np.int32),
            "worker_mask": wmask}


def _jax_model(argv):
    jargs = j_parse(argv=argv + ["--no_telemetry"])
    jm = JResNet9(channels=TINY)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    assert jfm.mesh is not None and jfm.mesh.devices.size == 2
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    return jfm, jopt


def _jax_rounds(jfm, jopt):
    out = []
    for rnd in range(3):
        res = jfm(_batch(rnd))
        jopt.step()
        out.append((res, np.asarray(ravel_pytree(jfm.params)[0])))
    return out


def _check(jout, tout, flat0, what):
    jprev = tprev = flat0
    for rnd, ((jres, jw), t) in enumerate(zip(jout, tout["rounds"])):
        (jl, ja, jd, ju), (tl, ta, td, tu) = jres, t["res"]
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=what)
        np.testing.assert_array_equal(ta, ja, err_msg=what)
        np.testing.assert_array_equal(tu, ju, err_msg=what)
        tw = t["w"]
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} round {rnd}")
        jsel = set(np.flatnonzero(jw != jprev))
        tsel = set(np.flatnonzero(tw != tprev))
        assert len(jsel & tsel) >= 0.99 * max(len(jsel), 1), (what, rnd)
        jprev, tprev = jw, tw


def _cv_train_spec(tmp):
    argv = ["--device", "cpu", "--dataset_name", "CIFAR10",
            "--dataset_dir", str(tmp / "data"), "--num_epochs", "1",
            "--num_workers", "4", "--local_batch_size", "4", "--iid",
            "--num_clients", "8", "--mode", "sketch", "--error_type",
            "virtual", "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--k", "500", "--num_cols", "2048", "--num_rows", "3",
            "--num_blocks", "2", "--lr_scale", "0.01", "--pivot_epoch",
            "0.5", "--seed", "0", "--server_shard", "--collective_plan",
            "int8", "--checkpoint", "--checkpoint_path", str(tmp / "ck")]
    env = {"COMMEFFICIENT_TINY_MODEL": "1",
           "COMMEFFICIENT_SYNTHETIC_PER_CLASS": "8"}
    return {"argv": argv, "env": env}


def _gpt2_train_spec(tmp):
    argv = ["--device", "cpu", "--num_epochs", "1", "--num_workers", "2",
            "--local_batch_size", "2", "--max_seq_len", "32", "--mode",
            "sketch", "--error_type", "virtual", "--local_momentum", "0",
            "--virtual_momentum", "0.9", "--k", "5000", "--num_cols",
            "20000", "--num_rows", "3", "--num_blocks", "2", "--seed", "0",
            "--dataset_dir", str(tmp / "gdata")]
    env = {"COMMEFFICIENT_TINY_MODEL": "1",
           "COMMEFFICIENT_SYNTHETIC_CLIENTS": "8",
           "COMMEFFICIENT_RUN_DIR": str(tmp / "run")}
    return {"argv": argv, "env": env}


MODES = {"sketch": SKETCH, "true_topk": TOPK}
PART = ["--server_shard", "--inject_client_fault",
        "drop=0.1,slow=0.3,corrupt=0.1,delay=1,seed=3"]
PART_RUNS = [SKETCH + COMMON + PART,
             SKETCH + COMMON + PART + ["--async_buffer", "2"]]
PART_ROUNDS = 5


def _jax_participation(argv):
    """JAX's rounds with the layer attached: per round the weights, the
    cohort record and the counters."""
    jfm, jopt = _jax_model(argv)
    ctl = j_attach_participation(jfm.args, jfm)
    out = []
    for rnd in range(PART_ROUNDS):
        h = jfm.begin_round(_batch(rnd))
        jopt.step()
        jfm.finish_round(h)
        out.append({"w": np.asarray(ravel_pytree(jfm.params)[0]),
                    "cohort": h.cohort, "counters": ctl.counters()})
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The port's side of every test here from one spawn of 2 ranks
    (each mode's replicated and sharded runs, then the two entry points),
    and JAX's rounds on its 2-device mesh, computed while the ranks
    run."""
    tmp = tmp_path_factory.mktemp("dist_rounds")
    jax_models, items = {}, []
    for mode, flags in MODES.items():
        base = flags + COMMON
        jax_models[mode] = [_jax_model(base),
                            _jax_model(base + ["--server_shard"])]
        flat0 = np.asarray(ravel_pytree(jax_models[mode][0][0].params)[0])
        items.append(("body_rounds",
                      {"runs": [base, base + ["--server_shard"]],
                       "batches": [_batch(r) for r in range(3)],
                       "flat0": flat0, "num_clients": NCLIENTS, "lr": LR}))
    items += [("cli_cv_train", _cv_train_spec(tmp)),
              ("cli_gpt2_train", _gpt2_train_spec(tmp)),
              ("body_participation",
               {"runs": PART_RUNS,
                "batches": [_batch(r) for r in range(PART_ROUNDS)],
                "flat0": items[0][1]["flat0"], "num_clients": NCLIENTS,
                "lr": LR, "save_at": 2, "dir": str(tmp)})]
    with start_ranks(2, items, tmp) as ranks:
        jax_out = {mode: [_jax_rounds(*m) for m in ms]
                   for mode, ms in jax_models.items()}
        jax_part = [_jax_participation(argv) for argv in PART_RUNS]
        outs = ranks.join()
    res = {mode: (items[i][1]["flat0"], jax_out[mode], outs[i])
           for i, mode in enumerate(MODES)}
    res.update(tmp=tmp, cv_train=outs[2], gpt2_train=outs[3],
               participation=(jax_part, outs[4]))
    return res


@pytest.mark.parametrize("mode", ["sketch", "true_topk"])
def test_two_ranks_match_jax_two_device_mesh(mode, spawned):
    flat0, (jrep, jsh), outs = spawned[mode]
    for r in (0, 1):
        rep, sh = outs[r]
        _check(jrep, rep, flat0, f"{mode} replicated rank {r}")
        _check(jsh, sh, flat0, f"{mode} sharded rank {r}")
        for a, b in zip(rep["rounds"], sh["rounds"]):
            np.testing.assert_array_equal(a["w"].view(np.uint32),
                                          b["w"].view(np.uint32))
    for a, b in zip(outs[0][1]["rounds"], outs[1][1]["rounds"]):
        np.testing.assert_array_equal(a["w"].view(np.uint32),
                                      b["w"].view(np.uint32))


def test_cv_train_entry_point_on_two_ranks(spawned):
    """``cv_train.main`` on 2 gloo ranks with the environment ``torchrun``
    sets (``--server_shard --collective_plan int8 --checkpoint``): rank 0
    prepares the synthetic data first, both ranks end with the same
    finite summary, and one checkpoint is written."""
    outs = [dict(o) for o in spawned["cv_train"]]
    for o in outs:
        o.pop("train_time")
        o.pop("total_time")
    assert outs[0] == outs[1]
    assert np.isfinite(outs[0]["train_loss"]) and outs[0]["up (MiB)"] > 0
    assert sorted(os.listdir(spawned["tmp"] / "ck")) == ["ResNet9.npz"]


def test_gpt2_train_entry_point_on_two_ranks(spawned):
    """``gpt2_train.train`` on 2 gloo ranks as under ``torchrun``: the
    same finite val NLL on both, one ``model.npz`` (rank 0's)."""
    outs = [dict(o) for o in spawned["gpt2_train"]]
    for o in outs:
        o.pop("val_time")
        o.pop("total_time")
    assert outs[0] == outs[1] and np.isfinite(outs[0]["val_nll"])
    assert os.path.exists(spawned["tmp"] / "run" / "model.npz")


def test_participation_server_shard_fold_matches_jax(spawned):
    """Faults with late landing and ``--async_buffer 2`` under
    ``--server_shard`` on 2 ranks: each rank folds its partial sums (the
    finiteness verdict AND-ed over the ranks), and the cohort records and
    counters equal JAX's, the weights within the tolerance of the rounds
    above; both ranks hold the same weights bit for bit, and a run state
    saved after 2 rounds (the held partial sums stacked as JAX stacks
    them) resumes bit-equal to the continuous run."""
    jax_part, outs = spawned["participation"]
    for run, jrun in enumerate(jax_part):
        for r in (0, 1):
            assert outs[r][run]["held_at_save"] > 0, (run, r)
            np.testing.assert_array_equal(
                outs[r][run]["resumed_w"].view(np.uint32),
                outs[r][run]["rounds"][-1]["w"].view(np.uint32))
            for rnd, (t, j) in enumerate(zip(outs[r][run]["rounds"],
                                             jrun)):
                what = f"run {run} rank {r} round {rnd}"
                assert t["cohort"] == j["cohort"], what
                assert t["counters"] == j["counters"], what
                np.testing.assert_allclose(t["w"], j["w"], rtol=1e-4,
                                           atol=1e-6, err_msg=what)
        for a, b in zip(outs[0][run]["rounds"], outs[1][run]["rounds"]):
            np.testing.assert_array_equal(a["w"].view(np.uint32),
                                          b["w"].view(np.uint32))
        c = jrun[-1]["counters"]
        assert c["slows"] and c["landed"], c
    assert jax_part[1][-1]["counters"]["folds"] >= 2
