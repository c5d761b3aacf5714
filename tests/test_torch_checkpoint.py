"""The port's checkpoint and run state (``federated/checkpoint.py``)
against the JAX package's on the CPU, and its resume.

- A run state the JAX package's ``save_run_state`` wrote after 2 sketch
  rounds restores in the port, and the third round matches JAX: the hash
  geometry, the error table the server queries, the top-k threshold and
  the kept set bit for bit (from JAX's round-3 table, each package
  running its own query and descent), the weights within
  ``rtol=1e-4, atol=1e-6`` and the losses within ``rtol=1e-4`` (the
  tolerance of ``tests/test_torch_rounds.py``: the client gradients come
  from another framework's convolutions, which sum in another order).
- The content checksum is the JAX package's, value for value, and the
  port's file carries the JAX file's keys with their shapes and dtypes
  (the port's generator state replaces JAX's ``rng`` key).
- The JAX package's ``load_checkpoint`` reads the port's final
  ``--checkpoint`` file (``--batchnorm``, so the model state is in it),
  and flax's ResNet9 gives the port's logits from it (eval mode;
  ``rtol=1e-4, atol=1e-5``, convolution order as above).
- ``cv_train`` resumed mid-epoch (``--checkpoint_every_rounds 2``, then
  ``--resume auto``) ends bit-identical to the run it continues.
- Corrupt, truncated, half-written, pruned, mismatched and unported
  files fail or are skipped as the JAX package's are; a drawn
  ``--client_dropout`` stream restores and draws on as JAX's does.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated import LambdaLR as JLambdaLR  # noqa: E402
from commefficient_tpu.federated import checkpoint as jck  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    model_state_from_flax,
    params_from_flax,
)
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR  # noqa: E402
from commefficient_torch.federated import checkpoint as tck  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

import importlib  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
W, B, NCLIENTS, K = 4, 4, 8, 500
ARGV = ["--mode", "sketch", "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", str(K), "--num_cols", "2048", "--num_rows", "3",
        "--num_blocks", "2", "--num_workers", str(W), "--num_devices", "1",
        "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
        "--local_batch_size", str(B), "--seed", "0"]
MID = {"rounds_done": 2,
       "sampler": {"permuted": np.arange(12, dtype=np.int64),
                   "cursor": np.array([2, 0, 4, 1, 0, 0, 3, 2], np.int64)},
       "extras": {"losses": np.array([2.5, 2.25]),
                  "download": np.arange(NCLIENTS, dtype=np.float64)}}


def _batch(rnd):
    rng = np.random.RandomState(400 + rnd)
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


def _lam(step):
    return 0.05 * (1 + step)


def _port(flat0, argv=ARGV):
    args = t_parse(argv=argv + ["--device", "cpu"])
    tm = ResNet9(channels=TINY)
    layout = ParamLayout(tm)
    train, val = t_losses(tm)
    fm = FedModel(tm, train, args, val, num_clients=NCLIENTS,
                  init_params=flat_from_jax(flat0, layout), device="cpu")
    opt = FedOptimizer(fm, args)
    return fm, opt, LambdaLR(opt, _lam)


def _flat(fm):
    return fm.layout.unchunk(fm.ps_weights).numpy().copy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX: 2 rounds, its run state, then round 3. Port: the same 2
    rounds and its own run state; and a port model restored from JAX's
    file that runs round 3."""
    d = tmp_path_factory.mktemp("ckpt")
    jargs = j_parse(argv=ARGV + ["--no_telemetry"])
    jm = JResNet9(channels=TINY)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    assert jfm.mesh is None or jfm.mesh.devices.size == 1
    jopt = JFedOptimizer(jfm, jargs)
    jsched = JLambdaLR(jopt, _lam)
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])

    tfm, topt, tsched = _port(flat0)
    np.random.seed(11)
    for rnd in range(2):
        b = _batch(rnd)
        for sched, fm, opt in ((jsched, jfm, jopt), (tsched, tfm, topt)):
            sched.step()
            fm(b)
            opt.step()
    jpath = jck.save_run_state(str(d / "jax" / "run_state_ep1_r2"), jfm,
                               jopt, jsched, next_epoch=0,
                               totals=(1.5, 2.5), mid_epoch=MID)
    tpath = tck.save_run_state(str(d / "port" / "run_state_ep1_r2"), tfm,
                               topt, tsched, next_epoch=0,
                               totals=(1.5, 2.5), mid_epoch=MID)

    # restore JAX's file into a fresh port model (other weights, np RNG)
    rfm, ropt, rsched = _port(np.zeros_like(flat0))
    np.random.seed(99)
    restored = tck.load_run_state(jpath, rfm, ropt, rsched)
    after_load = dict(
        ps=_flat(rfm), np_rng=np.random.get_state()[1].copy(),
        server=[t.numpy().copy() for t in ropt.server_state[:2]],
        last_changed=rfm._last_changed.numpy().copy(),
        prev_ps=rfm._prev_ps.numpy().copy(), lr=ropt.get_lr())

    # round 3: JAX, with its table and pre-step state kept
    b3 = _batch(2)
    jsched.step()
    jres = jfm(b3)
    jtable = np.asarray(jfm._round_ctx.gradient)
    jstate = [np.asarray(x) for x in jopt.server_state[:2]]
    jopt.step()
    rsched.step()
    rres = rfm(b3)
    rtable = rfm._round_ctx.gradient.numpy().copy()
    rstate = [t.numpy().copy() for t in ropt.server_state[:2]]
    ropt.step()
    return dict(dir=d, jpath=jpath, tpath=tpath, flat0=flat0, jfm=jfm,
                jopt=jopt, rfm=rfm, ropt=ropt, restored=restored,
                after_load=after_load, jres=jres, rres=rres, jtable=jtable,
                rtable=rtable, jstate=jstate, rstate=rstate,
                jw=np.asarray(ravel_pytree(jfm.params)[0]), rw=_flat(rfm))


def test_jax_run_state_restores_in_port(runs):
    jflat = jck._read_npz(runs["jpath"])
    meta = json.loads(bytes(jflat.pop("meta_json")).decode())
    next_epoch, totals, mid = runs["restored"]
    assert (next_epoch, totals) == (0, (1.5, 2.5))
    assert mid["rounds_done"] == 2
    for key in ("permuted", "cursor"):
        np.testing.assert_array_equal(mid["sampler"][key],
                                      MID["sampler"][key])
    for key, val in MID["extras"].items():
        np.testing.assert_array_equal(mid["extras"][key], val)
    a = runs["after_load"]
    np.testing.assert_array_equal(a["ps"], jflat["ps_weights"])
    np.testing.assert_array_equal(a["server"][0], jflat["server/velocity"])
    np.testing.assert_array_equal(a["server"][1], jflat["server/error"])
    np.testing.assert_array_equal(a["np_rng"], jflat["np_rng/keys"])
    np.testing.assert_array_equal(
        runs["rfm"].layout.unchunk(torch.from_numpy(a["prev_ps"])).numpy(),
        jflat["acct/prev_ps"])
    lc = a["last_changed"].reshape(-1)
    d = runs["rfm"].grad_size
    np.testing.assert_array_equal(lc[:d], jflat["acct/last_changed"])
    assert np.all(lc[d:] == -1)  # the chunked tail keeps its sentinel
    assert a["lr"] == _lam(meta["lr_step_count"])
    assert runs["rfm"].rounds_dispatched == meta["rounds_dispatched"] + 1


def test_third_round_matches_jax(runs):
    rfm, jfm = runs["rfm"], runs["jfm"]
    # the hash geometry
    for name in ("shift_q", "shift_w", "sign_keys"):
        np.testing.assert_array_equal(getattr(rfm.sketch, name).numpy(),
                                      np.asarray(getattr(jfm.sketch, name)))
    # the server state the third round starts from is JAX's, bit for bit
    for got, want in zip(runs["rstate"], runs["jstate"]):
        np.testing.assert_array_equal(got, want)
    # from JAX's round-3 table: the error table, threshold and kept set
    g, (vel, err) = runs["jtable"], runs["jstate"]
    terr = torch.from_numpy(err) + (torch.from_numpy(g)
                                    + 0.9 * torch.from_numpy(vel))
    jerr = jnp.asarray(err) + (jnp.asarray(g) + 0.9 * jnp.asarray(vel))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    test_ = tsk.estimates_chunks(rfm.sketch, terr)
    jest = jsk.estimates_chunks(jfm.sketch, jerr)
    np.testing.assert_array_equal(test_.numpy(), np.asarray(jest))
    assert int(ttk.resolve_threshold(test_, K)) == \
        int(jtk.resolve_threshold(jest, K))
    tupd = tsk.unsketch_chunks(rfm.sketch, terr, K).numpy()
    jupd = np.asarray(jsk.unsketch_chunks(jfm.sketch, jerr, K))
    np.testing.assert_array_equal(np.flatnonzero(tupd),
                                  np.flatnonzero(jupd))
    # the round as a whole
    np.testing.assert_allclose(runs["rtable"], runs["jtable"], rtol=1e-4,
                               atol=1e-6)
    (jl, ja, jd, ju), (tl, ta, td, tu) = runs["jres"], runs["rres"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_allclose(td, jd, rtol=0.01)
    np.testing.assert_allclose(runs["rw"], runs["jw"], rtol=1e-4, atol=1e-6)


def test_checksum_is_jax_checksum(runs):
    flat = jck._read_npz(runs["jpath"])
    flat.pop("meta_json")
    assert tck._content_checksum(flat) == jck._content_checksum(flat)
    rng = np.random.RandomState(0)
    arrays = {"b/x": rng.randn(3, 4).astype(np.float32),
              "a": rng.randint(0, 9, 7).astype(np.int64),
              "c/m": rng.rand(5) > 0.5, "d": np.arange(6, dtype=np.uint8),
              "meta_json": np.zeros(3, np.uint8)}
    assert tck._content_checksum(arrays) == jck._content_checksum(arrays)
    # the JAX package verifies the port's file
    tflat = jck._read_npz(runs["tpath"])
    meta = json.loads(bytes(tflat.pop("meta_json")).decode())
    jck._verify_checksum(tflat, meta, runs["tpath"])


def test_port_file_keys_match_jax(runs):
    jflat = jck._read_npz(runs["jpath"])
    tflat = jck._read_npz(runs["tpath"])
    jmeta = json.loads(bytes(jflat.pop("meta_json")).decode())
    tmeta = json.loads(bytes(tflat.pop("meta_json")).decode())
    # the JAX package's key data of its PRNG, which the port's generator
    # state replaces
    jonly = {"rng"}
    assert set(jflat) - jonly == set(tflat) - {"torch_rng/state"}
    for k in set(jflat) & set(tflat):
        assert tflat[k].shape == jflat[k].shape, k
        assert tflat[k].dtype == jflat[k].dtype, k
    assert set(tmeta) == set(jmeta) - {"rng_impl"}
    for k in ("next_epoch", "lr_step_count", "total_download",
              "total_upload", "round_idx", "rounds_dispatched",
              "mid_epoch"):
        assert tmeta[k] == jmeta[k], k
    # the two rounds themselves: the same sampler draws and accounting
    np.testing.assert_array_equal(tflat["np_rng/keys"], jflat["np_rng/keys"])
    np.testing.assert_array_equal(tflat["acct/client_part_round"],
                                  jflat["acct/client_part_round"])
    np.testing.assert_allclose(tflat["ps_weights"], jflat["ps_weights"],
                               rtol=1e-4, atol=1e-6)


CV = ["--dataset_name", "CIFAR10", "--num_epochs", "1", "--num_workers",
      "2", "--local_batch_size", "4", "--valid_batch_size", "8", "--iid",
      "--num_clients", "4", "--mode", "sketch", "--error_type", "virtual",
      "--local_momentum", "0", "--virtual_momentum", "0.9", "--k", "500",
      "--num_cols", "2048", "--num_rows", "3", "--num_blocks", "2",
      "--lr_scale", "0.4", "--pivot_epoch", "0.5", "--seed", "0",
      "--device", "cpu", "--batchnorm", "--checkpoint",
      "--metrics_drain_every", "3"]


@pytest.fixture(scope="module")
def cv_runs(tmp_path_factory):
    """``cv_train`` on synthetic CIFAR10 with ``--batchnorm``: once
    through with ``--checkpoint_every_rounds 2``, and once resumed with
    ``--resume auto`` from its round-2 run state."""
    from commefficient_torch import cv_train

    d = tmp_path_factory.mktemp("cv")
    env = {"COMMEFFICIENT_TINY_MODEL": "1",
           "COMMEFFICIENT_SYNTHETIC_PER_CLASS": "6"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        common = CV + ["--dataset_dir", str(d / "data")]
        full = cv_train.main(common + ["--checkpoint_path", str(d / "full"),
                                       "--checkpoint_every_rounds", "2"])
        os.makedirs(d / "res")
        shutil.copy(d / "full" / "run_state_ep1_r2.npz", d / "res")
        res = cv_train.main(common + ["--checkpoint_path", str(d / "res"),
                                      "--resume", "auto"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return d, full, res


def test_mid_epoch_resume_bit_identical(cv_runs):
    d, full, res = cv_runs
    names = set(os.listdir(d / "full"))
    assert {"ResNet9.npz", "run_state_ep1_r2.npz",
            "run_state_ep1_r4.npz"} <= names
    a = tck._flatten(dict(zip("pm", tck.load_checkpoint(
        str(d / "full" / "ResNet9")))))
    b = tck._flatten(dict(zip("pm", tck.load_checkpoint(
        str(d / "res" / "ResNet9")))))
    assert sorted(a) == sorted(b)
    assert any(k.startswith("m/") for k in a)  # the BatchNorm statistics
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for key in ("train_loss", "train_acc", "test_loss", "test_acc",
                "down (MiB)", "up (MiB)"):
        assert full[key] == res[key], key


def test_jax_reads_port_checkpoint(cv_runs):
    d = cv_runs[0]
    jparams, jstate = jck.load_checkpoint(str(d / "full" / "ResNet9"))
    tparams, tstate = tck.load_checkpoint(str(d / "full" / "ResNet9"))
    chans = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
    jm = JResNet9(do_batchnorm=True, channels=chans)
    x = np.random.RandomState(5).randn(4, 32, 32, 3).astype(np.float32)
    jlog = jm.apply({"params": jparams, "batch_stats": jstate},
                    jnp.asarray(x), train=False)
    tm = ResNet9(channels=chans, do_batchnorm=True)
    p = params_from_flax(tparams, ParamLayout(tm))
    tlog, _ = torch.func.functional_call(
        tm, p, (torch.from_numpy(x), model_state_from_flax(tstate), False))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-5)


def _write(path, flat, meta):
    arrays = dict(flat)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def _fault(case, src, tmp):
    """Set up one fault case in ``tmp``; returns what to check."""
    flat = tck._read_npz(src)
    meta = json.loads(bytes(flat.pop("meta_json")).decode())
    good = os.path.join(tmp, "run_state_ep1_r2.npz")
    shutil.copy(src, good)
    if case == "checksum":
        flat["ps_weights"] = flat["ps_weights"].copy()
        flat["ps_weights"][3] += 1.0
        _write(good, flat, meta)
    elif case == "truncated":
        newest = os.path.join(tmp, "run_state_ep1_r4.npz")
        with open(src, "rb") as f:
            data = f.read()
        with open(newest, "wb") as f:
            f.write(data[: len(data) // 2])
    elif case == "tmp":
        shutil.copy(src, os.path.join(tmp, "run_state_ep1_r6.tmp.npz"))
    elif case == "unported":
        # a per-axis plan's level carry (once unported, item 5a)
        flat["server/qres.1"] = np.zeros((4, 3), np.float32)
        meta["checksum"] = tck._content_checksum(flat)
        _write(good, flat, meta)
    elif case == "dropout":
        # a --client_dropout stream that has been drawn from
        rs = np.random.RandomState(0 + 2)
        rs.random_sample(4)
        _, keys, pos, gauss, cached = rs.get_state()
        flat["drop_rng/keys"] = keys
        flat["drop_rng/meta"] = np.asarray([pos, gauss], np.int64)
        flat["drop_rng/cached"] = np.asarray([cached], np.float64)
        meta["checksum"] = tck._content_checksum(flat)
        _write(good, flat, meta)
    return good


@pytest.mark.parametrize("case", ["checksum", "truncated", "tmp", "prune",
                                  "geometry", "unported", "dropout"])
def test_faults(runs, case, tmp_path, capsys):
    good = _fault(case, runs["tpath"], str(tmp_path))
    fm, opt, sched = _port(runs["flat0"])
    if case == "checksum":
        with pytest.raises(RuntimeError, match="checksum mismatch"):
            tck.load_run_state(good, fm, opt, sched)
        assert tck.find_resume_checkpoint(str(tmp_path)) is None
    elif case == "truncated":
        # the newest file is torn: --resume auto falls back to r2
        with pytest.raises(RuntimeError, match="corrupt or truncated"):
            tck.load_run_state(str(tmp_path / "run_state_ep1_r4.npz"), fm,
                               opt, sched)
        assert tck.find_resume_checkpoint(str(tmp_path)) == good
        assert "skipping" in capsys.readouterr().out
    elif case == "tmp":
        assert [os.path.basename(p) for p in
                tck._run_state_files(str(tmp_path))] == [
            "run_state_ep1_r2.npz"]
        os.remove(good)
        assert tck.find_resume_checkpoint(str(tmp_path)) is None
    elif case == "prune":
        for name in ("run_state_ep1.npz", "run_state_ep1_r8.npz",
                     "run_state_ep2_r3.npz", "run_state_ep1_r16.npz"):
            shutil.copy(good, tmp_path / name)
        tck.prune_run_states(str(tmp_path), 0)
        assert len(tck._run_state_files(str(tmp_path))) == 5
        tck.prune_run_states(str(tmp_path), 2)
        assert [os.path.basename(p) for p in
                tck._run_state_files(str(tmp_path))] == [
            "run_state_ep2_r3.npz", "run_state_ep1.npz"]
    elif case == "geometry":
        argv = [a if a != "2048" else "1024" for a in ARGV]
        fm2, opt2, sched2 = _port(runs["flat0"], argv)
        w0 = _flat(fm2)
        with pytest.raises(AssertionError,
                           match="checkpoint geometry mismatch: server "
                                 "velocity has shape"):
            tck.load_run_state(good, fm2, opt2, sched2)
        np.testing.assert_array_equal(_flat(fm2), w0)  # nothing restored
    elif case == "unported":
        # restored, not refused: the replicated plane has no carries, so
        # the level's key is not read, and the weights are the file's
        tck.load_run_state(good, fm, opt, sched)
        np.testing.assert_array_equal(
            _flat(fm), tck._read_npz(good)["ps_weights"])
    elif case == "dropout":
        # the drawn --client_dropout stream restores, and the next draw is
        # the one JAX's stream gives
        tck.load_run_state(good, fm, opt, sched)
        rs = np.random.RandomState(0 + 2)
        rs.random_sample(4)
        np.testing.assert_array_equal(fm._drop_rng.random_sample(5),
                                      rs.random_sample(5))


def test_dp_refuses_jax_rng(runs):
    fm, opt, sched = _port(runs["flat0"], ARGV + ["--dp"])
    with pytest.raises(ValueError, match="DP noise"):
        tck.load_run_state(runs["jpath"], fm, opt, sched)
    # a port file restores the generator state exactly
    fm2, opt2, sched2 = _port(runs["flat0"], ARGV + ["--dp"])
    tck.load_run_state(runs["tpath"], fm2, opt2, sched2)
    state = tck._read_npz(runs["tpath"])["torch_rng/state"]
    np.testing.assert_array_equal(fm2._rng.get_state().numpy(), state)
