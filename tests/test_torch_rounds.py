"""The port's FetchSGD round end to end against the JAX package on the CPU:
three rounds of ``FedModel`` / ``FedOptimizer`` from the same weights and
batches (the JAX side on one device), the data loader's batches, and one
tiny ``commefficient_torch.cv_train.main`` run.

Tolerances: the client phase sums per-client gradients in another order
than XLA (and PyTorch's CPU convolutions differ from XLA's in the last
bits), so per-round losses agree to ``rtol=1e-4`` and weights to
``rtol=1e-4, atol=1e-6``; coordinates near the top-k cut can swap, so the
selected sets must overlap by at least 0.99 per round.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
W, B, NCLIENTS = 4, 4, 8
ARGV = ["--mode", "sketch", "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", "500", "--num_cols", "2048", "--num_rows", "3",
        "--num_blocks", "2", "--num_workers", str(W), "--num_devices", "1",
        "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
        "--local_batch_size", str(B), "--seed", "0", "--no_telemetry"]
LR = 0.1


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


@pytest.fixture(scope="module")
def trajectories():
    jargs = j_parse(argv=ARGV)
    jm = JResNet9(channels=TINY)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    # one device: a psum over a multi-device mesh sums partial tables in
    # another order
    assert jfm.mesh is None or jfm.mesh.devices.size == 1
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])

    targs = t_parse(argv=ARGV + ["--device", "cpu"])
    tm = ResNet9(channels=TINY)
    layout = ParamLayout(tm)
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=NCLIENTS,
                   init_params=flat_from_jax(flat0, layout), device="cpu")
    topt = FedOptimizer(tfm, targs)
    topt.set_lr_factor(LR)

    out = []
    for rnd in range(3):
        b = _batch(rnd)
        jres = jfm(b)
        jopt.step()
        tres = tfm(b)
        topt.step()
        jw = np.asarray(ravel_pytree(jfm.params)[0])
        tw = tfm.layout.unchunk(tfm.ps_weights).numpy().copy()
        out.append((jres, tres, jw, tw))
    # FedModel.params are views of the same weights, in JAX ravel order
    np.testing.assert_array_equal(layout.flatten(tfm.params).numpy(), tw)
    vb = {"inputs": _batch(7)["inputs"][0], "targets": _batch(7)["targets"][0],
          "mask": np.ones(B, np.float32)}
    jfm.train(False)
    tfm.train(False)
    return flat0, out, jfm(vb), tfm(vb)


def test_round_losses_and_metrics(trajectories):
    _, out, _, _ = trajectories
    for jres, tres, _, _ in out:
        (jl, ja, jd, ju), (tl, ta, td, tu) = jres, tres
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tu, ju)
        # download counts coordinates changed since last participation:
        # the same up to the few swapped at the top-k cut
        np.testing.assert_allclose(td, jd, rtol=0.01)


def test_weights_and_selected_sets(trajectories):
    flat0, out, _, _ = trajectories
    jprev = tprev = flat0
    for rnd, (_, _, jw, tw) in enumerate(out):
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
        jsel = set(np.flatnonzero(jw != jprev))
        tsel = set(np.flatnonzero(tw != tprev))
        assert len(jsel) >= 500 and len(tsel) >= 500
        overlap = len(jsel & tsel) / max(len(jsel), len(tsel))
        assert overlap >= 0.99, (rnd, overlap)
        jprev, tprev = jw, tw


def test_val_call(trajectories):
    _, _, jval, tval = trajectories
    assert len(tval) == len(jval) == 2
    np.testing.assert_allclose(tval[0], jval[0], rtol=1e-4)
    np.testing.assert_array_equal(tval[1], jval[1])


def test_loader_batches_match_jax(tmp_path, monkeypatch):
    """Same seed, same synthetic data: the port's loader yields the JAX
    loader's batches (both on their numpy per-item paths; the native
    batch paths are held against each other in
    ``tests/test_torch_cv_data.py``)."""
    from commefficient_tpu.data_utils import FedCIFAR10 as JCifar
    from commefficient_tpu.data_utils import FedLoader as JLoader
    from commefficient_tpu.data_utils import transforms as jtr
    from commefficient_torch.data_utils import FedCIFAR10, FedLoader
    from commefficient_torch.data_utils import transforms as ttr

    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "12")
    batches = []
    for cls, loader_cls, tr, extra in (
            (JCifar, JLoader, jtr, {"use_native": False}),
            (FedCIFAR10, FedLoader, ttr, {"use_native": False})):
        np.random.seed(3)
        d = tmp_path / cls.__module__.split(".")[0]
        train = cls(str(d), "CIFAR10", tr.cifar10_train_transforms, True, 6,
                    train=True, download=True)
        test = cls(str(d), "CIFAR10", tr.cifar10_test_transforms,
                   train=False)
        tl = loader_cls(train, 4, 5, **extra)
        vl = loader_cls(test, val_batch_size=8, **extra)
        got = [b for _, b in zip(range(3), tl)] + [next(iter(vl))]
        batches.append((tl.steps_per_epoch(), got))
    (jspe, jb), (tspe, tb) = batches
    assert jspe == tspe
    for j, t in zip(jb, tb):
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


def test_cv_train_main_cpu(tmp_path, monkeypatch):
    from commefficient_torch import cv_train

    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "24")
    summary = cv_train.main([
        "--dataset_name", "CIFAR10", "--dataset_dir", str(tmp_path / "d"),
        "--num_epochs", "1", "--num_workers", "2", "--local_batch_size", "4",
        "--valid_batch_size", "8", "--iid", "--num_clients", "4",
        "--mode", "sketch", "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", "500", "--num_cols", "2048", "--num_rows", "3",
        "--num_blocks", "2", "--lr_scale", "0.01", "--pivot_epoch", "0.5",
        "--seed", "0", "--device", "cpu", "--eval_before_start"])
    assert np.isfinite(summary["train_loss"])
    assert np.isfinite(summary["test_acc"])
    assert summary["up (MiB)"] > 0


# (--guards, --telemetry, --inject_fault, --staleness_decay,
# --participation, the host-state flags and --churn are ported now; their
# places are taken by flags of planes still unported)
@pytest.mark.parametrize("flag", [["--plan_error_budget", "0.1"],
                                  ["--model_devices", "2"],
                                  ["--shard_devices", "2"],
                                  ["--expert_devices", "2"],
                                  ["--pp_microbatches", "2"],
                                  ["--seq_parallel", "ring"],
                                  ["--n_experts", "2"],
                                  ["--pipeline_devices", "2"],
                                  ["--collective_plan", "auto"]])
def test_unported_options_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_parse(argv=ARGV + ["--device", "cpu"] + flag)


def test_churn_parse_error_names_the_entry():
    """``--churn 0.1`` (once a case of the unported flags) is a malformed
    schedule: it fails at parse time naming the bad entry, as the JAX
    package's does."""
    with pytest.raises(ValueError, match="bad entry '0.1'"):
        t_parse(argv=ARGV + ["--device", "cpu", "--churn", "0.1"])
    with pytest.raises(ValueError, match="bad entry '0.1'"):
        j_parse(argv=ARGV + ["--churn", "0.1"])


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without loading jax, flax or the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import commefficient_torch\n"
        "for m in pkgutil.walk_packages(commefficient_torch.__path__,\n"
        "                               'commefficient_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'commefficient_tpu'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('commefficient_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20, proc.stdout


def test_cuda_request_without_card_raises():
    from commefficient_torch.federated.aggregator import resolve_device

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_batchnorm_names_its_roadmap_item():
    """The name is kept from when ``--batchnorm`` raised naming ROADMAP
    queue 1 item 1c: it is ported now, so it parses with the JAX
    package's default (off), and the flags still unported name their
    items."""
    assert t_parse(argv=ARGV + ["--device", "cpu"]).do_batchnorm is False
    assert t_parse(argv=ARGV + ["--device", "cpu",
                                "--batchnorm"]).do_batchnorm is True
    assert t_parse(argv=ARGV + ["--device", "cpu", "--churn",
                                "join=1"]).churn == "join=1"
    with pytest.raises(NotImplementedError, match="item 7"):
        t_parse(argv=ARGV + ["--device", "cpu", "--n_experts", "2"])


def test_per_client_worker_path_not_ported():
    """The name is kept from when the per-client path was not ported: this
    config (local momentum and local error in sketch space) now builds and
    takes a round, and the server's legality asserts still hold."""
    tm = ResNet9(channels=TINY)
    ttrain, _ = t_losses(tm)
    argv = ARGV + ["--device", "cpu", "--local_momentum", "0.9",
                   "--error_type", "local", "--virtual_momentum", "0"]
    fm = FedModel(tm, ttrain, t_parse(argv=argv), num_clients=NCLIENTS,
                  device="cpu")
    opt = FedOptimizer(fm, t_parse(argv=argv))
    opt.set_lr_factor(LR)
    b = _batch(0)
    loss, _, _, upload = fm(b)
    opt.step()
    assert np.all(np.isfinite(loss)) and upload[b["client_ids"]].all()
    for rows in (fm.client_states.velocities, fm.client_states.errors):
        assert tuple(rows.shape) == (NCLIENTS,) + fm.sketch.table_shape
        touched = rows.reshape(NCLIENTS, -1).abs().sum(1) > 0
        assert touched.numpy().tolist() == [
            c in b["client_ids"] for c in range(NCLIENTS)]
    with pytest.raises(AssertionError, match="virtual_momentum 0"):
        FedModel(tm, ttrain, t_parse(argv=argv + ["--virtual_momentum",
                                                  "0.9"]),
                 num_clients=NCLIENTS, device="cpu")
    with pytest.raises(AssertionError, match="local_momentum 0"):
        FedModel(tm, ttrain, t_parse(argv=ARGV + ["--device", "cpu",
                                                  "--local_momentum", "0.9"]),
                 num_clients=NCLIENTS, device="cpu")
