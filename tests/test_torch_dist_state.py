"""The port's client group keeps what the single-device round keeps
(``tests/torch_dist_ranks.py``, 2 ``gloo`` ranks):

- **The RNG identity.** Every slot draws on 2 ranks what it draws on one
  device: the per-client path's DP noise (each slot's generator,
  ``rounds.slot_generators``: the new local error and velocity rows of a
  ``local_topk`` round with ``--dp`` are bit-equal), and the fused
  phase's GPT-2 dropout (every rank draws all W clients' masks, bit-equal
  to the single device's draws, and takes its own: the per-client losses
  agree to ``rtol=1e-6``; the forward of 2 clients in a batch of 4 or 2
  may round differently in the last bit).
- **The per-client path's replicated state** (client velocity and error
  rows, all-gathered) is identical on both ranks.
- **BatchNorm state** with a rank whose slots are all padding: the
  slot-weighted mean over the ranks equals the single device's mean to
  ``rtol=1e-6, atol=1e-7`` (the two sum in another order), and a round
  of padding alone keeps the state bit for bit.

- **Checkpoints** of the sharded plane: a quantized dense run
  (``--server_shard --collective_plan uplink=int8,downlink=fp8_e4m3``)
  restores into the same plan bit for bit (slices and carries), into the
  replicated plane (the gathered ``(d,)`` view) and into the fp32 sharded
  plan; a replicated sketch run restores into a quantized sharded plan,
  its carries restarting from zero with a warning, as the JAX package's
  cross-plane restore does.

One spawn of 2 ranks runs every body of this file in turn; the
single-device runs are made by its rank 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_dist_ranks import TINY, start_ranks  # noqa: E402

W, B, NCLIENTS, LR = 4, 4, 8, 0.1
COMMON = ["--num_workers", str(W), "--num_devices", "2",
          "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
          "--local_batch_size", str(B), "--seed", "0"]
SKETCH = ["--mode", "sketch", "--error_type", "virtual",
          "--local_momentum", "0", "--virtual_momentum", "0.9",
          "--k", "500", "--num_cols", "2048", "--num_rows", "3",
          "--num_blocks", "2"]


def _batch(rnd, wmask=None):
    rng = np.random.RandomState(300 + rnd)
    mask = np.ones((W, B), np.float32)
    wm = np.ones(W, np.float32) if wmask is None else \
        np.asarray(wmask, np.float32)
    mask[wm == 0] = 0.0
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": mask,
            "client_ids": rng.choice(NCLIENTS, W, replace=False)
            .astype(np.int32),
            "worker_mask": wm}


def _flat0():
    from commefficient_torch.federated.aggregator import init_model_
    from commefficient_torch.models import ResNet9
    from commefficient_torch.ops.flat import ParamLayout

    m = ResNet9(channels=TINY, do_batchnorm=True)
    init_model_(m, 0)
    return ParamLayout(m).flatten(dict(m.named_parameters())).numpy()


def _flat0_nobn():
    from commefficient_torch.federated.aggregator import init_model_
    from commefficient_torch.models import ResNet9
    from commefficient_torch.ops.flat import ParamLayout

    m = ResNet9(channels=TINY)
    init_model_(m, 0)
    return ParamLayout(m).flatten(dict(m.named_parameters())).numpy()


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _dp_item():
    argv = ["--mode", "local_topk", "--error_type", "local",
            "--local_momentum", "0.9", "--k", "500", "--dp",
            "--noise_multiplier", "0.5", "--l2_norm_clip", "1.0"] + COMMON
    spec = {"runs": [argv], "batches": [_batch(0)], "flat0": _flat0_nobn(),
            "num_clients": NCLIENTS, "lr": LR}
    return "body_rounds_and_single", spec


def test_per_client_dp_rng_and_replicated_state(spawned):
    res = spawned["dp"]
    single = res[0][1][0]
    outs = [r[0] for r in res]
    for r in (0, 1):
        got = outs[r][0]
        for name in ("cvel", "cerr"):
            np.testing.assert_array_equal(_u32(got[name]),
                                          _u32(single[name]), err_msg=name)
        (sl, sa, _, su), (tl, ta, _, tu) = single["rounds"][0]["res"], \
            got["rounds"][0]["res"]
        np.testing.assert_array_equal(_u32(tl), _u32(sl))
        np.testing.assert_array_equal(ta, sa)
        np.testing.assert_array_equal(tu, su)
        np.testing.assert_allclose(got["rounds"][0]["w"],
                                   single["rounds"][0]["w"], rtol=1e-5,
                                   atol=1e-7)
    for name in ("cvel", "cerr", "vel"):
        np.testing.assert_array_equal(_u32(outs[0][0][name]),
                                      _u32(outs[1][0][name]))
    assert np.abs(single["cerr"]).max() > 0


def _gpt2_batch():
    rng = np.random.RandomState(7)
    Tq, C = 8, 2
    lm = rng.randint(0, 64, (W, 2, C, Tq)).astype(np.int64)
    lm[..., :2] = -1
    return {"input_ids": rng.randint(0, 64, (W, 2, C, Tq)).astype(np.int64),
            "token_type_ids": rng.randint(0, 64, (W, 2, C, Tq))
            .astype(np.int64),
            "lm_labels": lm,
            "mc_token_ids": rng.randint(0, Tq, (W, 2, C)).astype(np.int64),
            "mc_labels": rng.randint(0, C, (W, 2)).astype(np.int64),
            "mask": np.ones((W, 2), np.float32),
            "client_ids": np.arange(W, dtype=np.int32),
            "worker_mask": np.ones(W, np.float32)}


def _dropout_spec():
    argv = ["--mode", "uncompressed", "--error_type", "none",
            "--local_momentum", "0", "--num_workers", str(W),
            "--num_clients", str(NCLIENTS), "--local_batch_size", "2",
            "--weight_decay", "0", "--seed", "3"]
    return {"argv": argv, "batch": _gpt2_batch(), "num_clients": NCLIENTS}


def test_fused_dropout_draws_are_the_single_rounds(spawned):
    single = spawned["dropout_single"][0]
    outs = spawned["dropout"]
    assert len(single["draws"]) == 1 and single["draws"][0].shape[0] == W
    for r in (0, 1):
        got = outs[r]
        assert len(got["draws"]) == len(single["draws"])
        for a, b in zip(got["draws"], single["draws"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got["res"][0], single["res"][0],
                                   rtol=1e-6)
    np.testing.assert_array_equal(_u32(outs[0]["w"]), _u32(outs[1]["w"]))


def _bn_item():
    argv = SKETCH + COMMON + ["--batchnorm"]
    spec = {"runs": [argv],
            "batches": [_batch(0, [1, 1, 0, 0]), _batch(1, [0, 0, 0, 0])],
            "flat0": _flat0(), "num_clients": NCLIENTS, "lr": LR}
    return "body_rounds_and_single", spec


def test_batchnorm_state_with_an_all_padding_rank(spawned):
    """Round 1: rank 1's slots are all padding; round 2: every slot is.
    After round 1 the state is the single device's to the stated
    tolerance; round 2 keeps it bit for bit, on every rank."""
    res = spawned["bn"]
    single = res[0][1][0]
    outs = [r[0] for r in res]
    assert single["ms"]
    for r in (0, 1):
        got = outs[r][0]
        first, second = got["rounds"]
        for k, v in single["rounds"][0]["ms"].items():
            np.testing.assert_allclose(first["ms"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_array_equal(_u32(second["ms"][k]),
                                          _u32(first["ms"][k]))
        np.testing.assert_allclose(first["w"], single["rounds"][0]["w"],
                                   rtol=1e-5, atol=1e-6)
    for k in single["ms"]:
        np.testing.assert_array_equal(_u32(outs[0][0]["ms"][k]),
                                      _u32(outs[1][0]["ms"][k]))


DENSE = ["--mode", "uncompressed", "--error_type", "none",
         "--local_momentum", "0", "--virtual_momentum", "0.9"]


def _checkpoint_specs(tmp):
    """A quantized dense run restored into three plans, and a replicated
    sketch run restored into a quantized sharded plan."""
    flat0 = _flat0_nobn()
    q = ["--server_shard", "--collective_plan",
         "uplink=int8,downlink=fp8_e4m3"]
    a = {"argv": DENSE + COMMON + q,
         "restore": [DENSE + COMMON + q, DENSE + COMMON,
                     DENSE + COMMON + ["--server_shard"]],
         "batches": [_batch(0), _batch(1)], "flat0": flat0,
         "num_clients": NCLIENTS, "lr": LR, "dir": str(tmp / "a")}
    b = {"argv": SKETCH + COMMON,
         "restore": [SKETCH + COMMON + ["--server_shard",
                                        "--collective_plan",
                                        "table=int8,downlink=int8"]],
         "batches": [_batch(0)], "flat0": flat0,
         "num_clients": NCLIENTS, "lr": LR, "dir": str(tmp / "b")}
    return a, b


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every body of this file in one spawn of 2 ranks, by name."""
    tmp = tmp_path_factory.mktemp("dist_state")
    ck_a, ck_b = _checkpoint_specs(tmp)
    items = {"dp": _dp_item(),
             "dropout_single": ("body_gpt2_dropout",
                                dict(_dropout_spec(), single=True)),
             "dropout": ("body_gpt2_dropout", _dropout_spec()),
             "bn": _bn_item(),
             "ck_a": ("body_checkpoint", ck_a),
             "ck_b": ("body_checkpoint", ck_b)}
    with start_ranks(2, list(items.values()), tmp) as ranks:
        return dict(zip(items, ranks.join()))


def test_checkpoint_round_trips_across_planes(spawned):
    outs = spawned["ck_a"]
    d = outs[0]["saved"]["w"].shape[0]
    full_vel = np.concatenate([o["saved"]["vel"] for o in outs])[:d]
    for r, o in enumerate(outs):
        same, rep, fp32 = o["restored"]
        for key in ("vel", "err", "qres", "dres"):
            np.testing.assert_array_equal(_u32(same[key]),
                                          _u32(o["saved"][key]), err_msg=key)
        assert not same["warnings"]
        np.testing.assert_array_equal(_u32(rep["vel"]), _u32(full_vel))
        assert rep["qres"] is None and rep["dres"] is None
        np.testing.assert_array_equal(_u32(fp32["vel"]),
                                      _u32(o["saved"]["vel"]))
        assert fp32["qres"] is None
        # the next round from the same plan's restore is the same on both
        # ranks
        np.testing.assert_array_equal(_u32(same["w_next"]),
                                      _u32(outs[0]["restored"][0]["w_next"]))

    outs = spawned["ck_b"]
    for o in outs:
        (sh,) = o["restored"]
        np.testing.assert_array_equal(_u32(sh["vel"]),
                                      _u32(o["saved"]["vel"]))
        assert not sh["qres"].any() and not sh["dres"].any()
        assert sum("re-initializing" in w for w in sh["warnings"]) == 2
        assert np.isfinite(sh["w_next"]).all()


@pytest.mark.parametrize("dp", [False, True])
def test_per_client_slots_draw_only_with_dp_or_dropout(dp):
    """On one device a per-client round whose slots draw nothing (no DP,
    no dropout) leaves the round generator as it was; with worker DP the
    slots' generators are built and the round generator moves on."""
    from tests.torch_dist_ranks import _resnet9_model

    argv = ["--mode", "local_topk", "--error_type", "local",
            "--local_momentum", "0.9", "--k", "500"] + COMMON
    if dp:
        argv += ["--dp", "--noise_multiplier", "0.5", "--l2_norm_clip",
                 "1.0"]
    fm, opt = _resnet9_model({"flat0": _flat0_nobn(),
                              "num_clients": NCLIENTS, "lr": LR}, None, argv)
    before = fm._rng.get_state().clone()
    fm(_batch(0))
    opt.step()
    assert torch.equal(fm._rng.get_state(), before) is not dp
