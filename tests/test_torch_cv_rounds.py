"""The FEMNIST and Fixup paths end to end against the JAX package on the
CPU: three sketched rounds of a reduced-depth ResNet-LN
(``ResNet(layers=(1, 1), norm="layer")``, the FEMNIST model's blocks)
on synthetic FEMNIST drawn through ``FedEMNIST``, the FEMNIST transforms
and ``FedLoader`` in each package, and three rounds of a tiny
FixupResNet9 with Fixup's LR groups; then
``commefficient_torch.cv_train`` end to end on EMNIST (with
``PrefetchLoader``), a ``--finetune`` run from a CIFAR checkpoint, and
the refusal of the BatchNorm models that the JAX package cannot train.

Per round: the batches are equal bit for bit; the sketch geometry (shift
arrays and sign keys) is equal; from the JAX round's table and server
state, the port's server step gives the same top-k threshold and kept set
bit for bit (values to ``rtol=1e-6, atol=1e-7``, as
``tests/test_torch_server.py``). Each package then runs its own
trajectory: losses to ``rtol=1e-4``, weights to ``rtol=1e-4, atol=1e-6``
and the coordinates a round moves overlapping by at least 0.99 (the
clients' convolutions sum in another order, so coordinates at the top-k
cut can swap; as ``tests/test_torch_rounds.py``).
"""

import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import cv_train as jcv  # noqa: E402
from commefficient_tpu import models as jmodels  # noqa: E402
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.data_utils import FedEMNIST as JEMNIST  # noqa: E402
from commefficient_tpu.data_utils import FedLoader as JLoader  # noqa: E402
from commefficient_tpu.data_utils import transforms as jtr  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated import server as jsrv  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch import cv_train as tcv  # noqa: E402
from commefficient_torch import models as tmodels  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.data_utils import FedEMNIST, FedLoader  # noqa: E402
from commefficient_torch.data_utils import transforms as ttr  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer  # noqa: E402
from commefficient_torch.federated import server as tsrv  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models.resnets import ResNet  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

W, B, LR = 4, 4, 0.1
SKETCH = ["--mode", "sketch", "--error_type", "virtual",
          "--local_momentum", "0", "--virtual_momentum", "0.9",
          "--k", "2000", "--num_cols", "8192", "--num_rows", "3",
          "--num_blocks", "2", "--num_devices", "1", "--seed", "0",
          "--no_telemetry", "--num_workers", str(W),
          "--local_batch_size", str(B)]
TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
LN_SMALL = dict(layers=(1, 1), norm="layer", initial_channels=1,
                num_classes=62)


@pytest.fixture(scope="module")
def emnist_batches(tmp_path_factory):
    """Three train rounds from each package's FedEMNIST + FEMNIST
    transforms + FedLoader, under one seed; 12 synthetic clients."""
    root = tmp_path_factory.mktemp("emnist_rounds")
    os.environ["COMMEFFICIENT_SYNTHETIC_CLIENTS"] = "12"
    os.environ["COMMEFFICIENT_SYNTHETIC_SAMPLES"] = "8"
    out = []
    try:
        for cls, loader_cls, tr, sub in ((JEMNIST, JLoader, jtr, "j"),
                                         (FedEMNIST, FedLoader, ttr, "t")):
            np.random.seed(0)
            ds = cls(str(root / sub), "EMNIST", tr.femnist_train_transforms,
                     False, None, train=True, download=True)
            loader = loader_cls(ds, W, B)
            out.append((ds.num_clients,
                        [b for _, b in zip(range(3), loader)]))
    finally:
        del os.environ["COMMEFFICIENT_SYNTHETIC_CLIENTS"]
        del os.environ["COMMEFFICIENT_SYNTHETIC_SAMPLES"]
    return out


def test_emnist_batches_equal(emnist_batches):
    (jn, jb), (tn, tb) = emnist_batches
    assert jn == tn == 12 and len(jb) == len(tb) == 3
    for j, t in zip(jb, tb):
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["inputs"].shape == (W, B, 28, 28, 1)


def _pair(jm, tm, argv, num_clients, hwc, groups):
    jargs = j_parse(argv=argv)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=hwc,
                    num_clients=num_clients)
    assert jfm.mesh is None or jfm.mesh.devices.size == 1
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])
    jopt = JFedOptimizer(jfm, jargs, param_groups=(
        jcv.build_param_groups(jargs, jfm.params) if groups else None))
    targs = t_parse(argv=argv + ["--device", "cpu"])
    layout = ParamLayout(tm)
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=num_clients,
                   init_params=flat_from_jax(flat0, layout), device="cpu")
    topt = FedOptimizer(tfm, targs, param_groups=(
        tcv.build_param_groups(targs, layout) if groups else None))
    jopt.set_lr_factor(LR)
    topt.set_lr_factor(LR)
    return jfm, jopt, tfm, topt, flat0


def _trajectory(jfm, jopt, tfm, topt, flat0, batches):
    js, ts = jfm.sketch, tfm.sketch
    for name in ("shift_q", "shift_w", "inv_q", "inv_w", "sign_keys"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    k = tfm.server_config.k
    jprev = tprev = flat0
    rows = []
    for b in batches:
        jh = jfm.begin_round(b)
        table = np.asarray(jfm._round_ctx.gradient)
        vel = np.asarray(jopt.server_state.velocity)
        err = np.asarray(jopt.server_state.error)
        lr = jopt.get_lr()
        # the port's server step from the JAX round's table and state
        e = err + table + 0.9 * vel
        jp = int(jtk.resolve_threshold(jsk.estimates_chunks(
            js, jnp.asarray(e)), k))
        tp = int(ttk.resolve_threshold(tsk.estimates_chunks(
            ts, torch.from_numpy(e)), k))
        assert tp == jp
        jupd, _ = jsrv.server_update(
            jnp.asarray(table), jsrv.ServerState(jnp.asarray(vel),
                                                 jnp.asarray(err)),
            jfm.server_config, lr, sketch=js, layout=js.chunk_layout)
        tlr = lr if np.ndim(lr) == 0 else torch.from_numpy(np.asarray(lr))
        tupd, _ = tsrv.server_update(
            torch.from_numpy(table), tsrv.ServerState(
                torch.from_numpy(vel), torch.from_numpy(err)),
            tfm.server_config, tlr, sketch=ts, layout=ts.chunk_layout)
        jupd = np.asarray(jupd)
        np.testing.assert_array_equal(tupd.numpy() != 0, jupd != 0)
        np.testing.assert_allclose(tupd.numpy(), jupd, rtol=1e-6,
                                   atol=1e-7)
        assert (jupd != 0).sum() >= k
        jopt.step()
        jres = jfm.finish_round(jh)
        # the port's own round
        tres = tfm(b)
        np.testing.assert_allclose(tfm._round_ctx.gradient.numpy(), table,
                                   rtol=1e-4, atol=1e-6)
        topt.step()
        np.testing.assert_allclose(tres[0], jres[0], rtol=1e-4)
        np.testing.assert_array_equal(tres[1], jres[1])
        jw = np.asarray(ravel_pytree(jfm.params)[0])
        tw = tfm.layout.unchunk(tfm.ps_weights).numpy().copy()
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
        jm_, tm_ = jw != jprev, tw != tprev
        assert jm_.sum() >= k
        overlap = (jm_ & tm_).sum() / max(jm_.sum(), tm_.sum())
        assert overlap >= 0.99, overlap
        jprev, tprev = jw, tw
        rows.append(float(np.mean(tres[0])))
    return rows


def test_resnet_ln_emnist_sketch_trajectory(emnist_batches):
    (n, batches), _ = emnist_batches
    argv = SKETCH + ["--dataset_name", "EMNIST", "--num_clients", str(n),
                     "--model", "ResNet101LN"]
    jfm, jopt, tfm, topt, flat0 = _pair(
        jmodels.ResNet(**LN_SMALL), ResNet(**LN_SMALL), argv, n,
        (28, 28, 1), groups=False)
    losses = _trajectory(jfm, jopt, tfm, topt, flat0, batches)
    assert np.all(np.isfinite(losses))


def _cifar_batch(rnd):
    rng = np.random.RandomState(200 + rnd)
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": np.ones((W, B), np.float32),
            "client_ids": rng.choice(8, W, replace=False).astype(np.int32),
            "worker_mask": np.ones(W, np.float32)}


def test_fixup_resnet9_groups_sketch_trajectory():
    """FixupResNet9 with Fixup's LR groups (the chunked LR vector) in
    sketch mode, three rounds."""
    argv = SKETCH + ["--dataset_name", "CIFAR10", "--num_clients", "8",
                     "--model", "FixupResNet9"]
    jfm, jopt, tfm, topt, flat0 = _pair(
        jmodels.FixupResNet9(channels=TINY),
        tmodels.FixupResNet9(channels=TINY), argv, 8, (32, 32, 3),
        groups=True)
    assert np.ndim(jopt.get_lr()) == 3
    _trajectory(jfm, jopt, tfm, topt, flat0,
                [_cifar_batch(r) for r in range(3)])


def _small_resnet101ln(num_classes=62, initial_channels=1, **kw):
    return ResNet(layers=(1, 1), norm="layer", num_classes=num_classes,
                  initial_channels=initial_channels)


def test_cv_train_emnist_finetune_and_refusals(tmp_path, monkeypatch):
    """``cv_train`` on synthetic EMNIST (ResNet101LN cut to two blocks,
    prefetch loaders), a CIFAR100 ResNet9 checkpoint, a ``--finetune``
    run from it on CIFAR10, and the BatchNorm models refused."""
    monkeypatch.setattr(tmodels, "ResNet101LN", _small_resnet101ln)
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_SAMPLES", "8")
    common = ["--num_epochs", "1", "--num_workers", "2",
              "--local_batch_size", "4", "--lr_scale", "0.01",
              "--pivot_epoch", "0.5", "--seed", "0", "--device", "cpu"]
    summary = tcv.main(common + [
        "--dataset_name", "EMNIST", "--model", "ResNet101LN",
        "--dataset_dir", str(tmp_path / "emnist"), "--mode", "sketch",
        "--error_type", "virtual", "--local_momentum", "0",
        "--virtual_momentum", "0.9", "--k", "500", "--num_cols", "2048",
        "--num_rows", "3", "--num_blocks", "2",
        "--train_dataloader_workers", "1", "--val_dataloader_workers", "1"])
    assert np.isfinite(summary["train_loss"])
    assert np.isfinite(summary["test_loss"])
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "4")
    cifar = common[:1] + ["0.5"] + common[2:] + [
        "--mode", "uncompressed", "--iid", "--num_clients", "4"]
    tcv.main(cifar + ["--dataset_name", "CIFAR100",
                      "--dataset_dir", str(tmp_path / "c100"),
                      "--checkpoint", "--checkpoint_path",
                      str(tmp_path / "ck")])
    assert os.path.exists(tmp_path / "ck" / "ResNet9.npz")
    summary = tcv.main(cifar + [
        "--dataset_name", "CIFAR10", "--dataset_dir", str(tmp_path / "c10"),
        "--finetune", "--finetuned_from", "CIFAR100", "--finetune_path",
        str(tmp_path / "ck")])
    assert np.isfinite(summary["train_loss"])
    for model in ("ResNet18", "ResNet"):
        with pytest.raises(NotImplementedError, match="has_bn"):
            tcv.main(cifar + ["--dataset_name", "CIFAR10", "--model", model,
                              "--dataset_dir", str(tmp_path / "c10")])


def test_build_model_and_config_follows_jax():
    """The model options: the finetune class counts (ResNet9 alone takes
    ``new_num_classes``), 1-channel EMNIST stems, the signature filter."""
    args = t_parse(argv=["--model", "ResNet9", "--dataset_name", "CIFAR10",
                         "--finetune", "--finetuned_from", "CIFAR100",
                         "--device", "cpu"])
    m = tcv.build_model_and_config(args)
    assert m.linear.weight.shape[0] == 10
    args.model = "FixupResNet9"
    m = tcv.build_model_and_config(args)
    assert m.linear.weight.shape[0] == 100  # num_classes of finetuned_from
    args = t_parse(argv=["--model", "ResNet101LN", "--dataset_name",
                         "EMNIST", "--device", "cpu"])
    m = tcv.build_model_and_config(args)
    assert ParamLayout(m).d == 42_620_926
    args = t_parse(argv=["--model", "FixupResNet50", "--dataset_name",
                         "ImageNet", "--device", "cpu"])
    assert ParamLayout(tcv.build_model_and_config(args)).d == 25_504_030
    args.dataset_name = "EMNIST"
    assert tcv.build_model_and_config(args).conv1.weight.shape[1] == 1
