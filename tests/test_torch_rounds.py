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
    loader's batches (the JAX side on its numpy path)."""
    from commefficient_tpu.data_utils import FedCIFAR10 as JCifar
    from commefficient_tpu.data_utils import FedLoader as JLoader
    from commefficient_tpu.data_utils import transforms as jtr
    from commefficient_torch.data_utils import FedCIFAR10, FedLoader
    from commefficient_torch.data_utils import transforms as ttr

    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "12")
    batches = []
    for cls, loader_cls, tr, extra in (
            (JCifar, JLoader, jtr, {"use_native": False}),
            (FedCIFAR10, FedLoader, ttr, {})):
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


@pytest.mark.parametrize("flag", [["--stream_sketch"], ["--fused_epilogue"],
                                  ["--server_shard"], ["--telemetry"],
                                  ["--resume", "auto"], ["--bf16"],
                                  ["--participation", "0.5"],
                                  ["--mode", "true_topk"],
                                  ["--num_devices", "4"]])
def test_unported_options_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_parse(argv=ARGV + ["--device", "cpu"] + flag)


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


def test_per_client_worker_path_not_ported():
    tm = ResNet9(channels=TINY)
    ttrain, _ = t_losses(tm)
    args = t_parse(argv=ARGV + ["--device", "cpu", "--local_momentum", "0.9",
                                "--error_type", "local",
                                "--virtual_momentum", "0"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FedModel(tm, ttrain, args, num_clients=NCLIENTS, device="cpu")

