"""Fixup's per-group LRs, finetune's head-only training and
``load_matching`` in the port against the JAX package on the CPU.

- ``cv_train.build_param_groups``: the Fixup masks (bias 0.1, scale 0.1,
  other 1.0) and the finetune masks equal the JAX package's, mask for
  mask, including its ``fc`` miss: the resnets' head key is ``fc/kernel``,
  which ``k.endswith("fc")`` never matches, so under ``--finetune`` every
  coordinate of a resnet trains at LR 0 in both packages.
- ``load_matching``: the loaded count and the skipped set equal the JAX
  package's, and the loaded leaves are the checkpoint's.
- ``FedOptimizer`` with groups: the per-coordinate LR vector equals the
  JAX package's (chunked ``(T, S, 128)`` with a zero tail in sketch mode),
  ``LambdaLR.get_last_lr`` lists one LR per group, and one server step
  per mode (sketch composed and with the fused epilogue, uncompressed,
  fedavg, whose clients take the vector) matches JAX's.

Tolerances: the server rules from one table and state, as
``tests/test_torch_server.py``: the kept set exactly, values to
``rtol=1e-6, atol=1e-7`` (XLA may contract ``g + m * v`` into a fused
multiply-add). A whole round from the same weights and batch, as
``tests/test_torch_modes.py``: ``rtol=1e-4, atol=1e-6`` (the clients'
convolutions sum in another order).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import cv_train as jcv  # noqa: E402
from commefficient_tpu import models as jmodels  # noqa: E402
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated import LambdaLR as JLambdaLR  # noqa: E402
from commefficient_tpu.federated import server as jsrv  # noqa: E402
from commefficient_tpu.federated.checkpoint import (  # noqa: E402
    load_checkpoint as j_load_checkpoint,
)
from commefficient_tpu.federated.checkpoint import (  # noqa: E402
    load_matching as j_load_matching,
)
from commefficient_tpu.federated.checkpoint import (  # noqa: E402
    save_checkpoint as j_save_checkpoint,
)
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_torch import cv_train as tcv  # noqa: E402
from commefficient_torch import models as tmodels  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    flax_from_port,
)
from commefficient_torch.federated import (  # noqa: E402
    FedModel,
    FedOptimizer,
    LambdaLR,
)
from commefficient_torch.federated import server as tsrv  # noqa: E402
from commefficient_torch.federated.checkpoint import load_matching  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
W, B, NCLIENTS, LR = 4, 4, 8, 0.1

# name: (model, JAX kwargs, input (H, W, C))
MODELS = {
    "FixupResNet9": ("FixupResNet9", dict(channels=TINY), (32, 32, 3)),
    "FixupResNet18": ("FixupResNet18", dict(num_blocks=(1, 1, 1, 1)),
                      (32, 32, 3)),
    "FixupResNet50": ("FixupResNet50", dict(layers=(1, 1, 1, 1),
                                            num_classes=10), (32, 32, 3)),
    "ResNet9": ("ResNet9", dict(channels=TINY), (32, 32, 3)),
    "ResNet18": ("ResNet18", dict(num_blocks=(1, 1, 1, 1)), (32, 32, 3)),
    "ResNet101LN": ("ResNet", dict(layers=(1, 1), norm="layer",
                                   initial_channels=1, num_classes=62),
                    (28, 28, 1)),
}


class _Args:
    def __init__(self, model, finetune):
        self.model = model
        self.do_finetune = finetune


def _pair(name):
    cls, kw, hwc = MODELS[name]
    jm = getattr(jmodels, cls)(**kw)
    params = jm.init(jax.random.key(0), jnp.zeros((1,) + hwc),
                     train=False)["params"]
    tkw = dict(kw)
    tkw["initial_channels"] = hwc[2]
    tm = getattr(tmodels, cls)(**tkw)
    return params, tm, ParamLayout(tm)


def _groups_equal(jg, tg):
    assert (jg is None) == (tg is None)
    if jg is None:
        return
    assert [b for _, b in jg] == [b for _, b in tg]
    for (jmask, _), (tmask, _) in zip(jg, tg):
        np.testing.assert_array_equal(tmask, np.asarray(jmask))


@pytest.mark.parametrize("name", ["FixupResNet9", "FixupResNet18",
                                  "FixupResNet50"])
@pytest.mark.parametrize("finetune", [False, True])
def test_fixup_groups_equal_jax(name, finetune):
    """Fixup's three groups, and under ``--finetune`` still Fixup's (the
    Fixup branch comes first in both packages)."""
    params, _, layout = _pair(name)
    args = _Args(name, finetune)
    jg = jcv.build_param_groups(args, params)
    tg = tcv.build_param_groups(args, layout)
    _groups_equal(jg, tg)
    assert [b for _, b in tg] == [0.1, 0.1, 1.0]
    bias, scale, other = (m for m, _ in tg)
    assert bias.any() and scale.any() and other.any()
    assert not (bias & scale).any()
    np.testing.assert_array_equal(bias | scale | other,
                                  np.ones(layout.d, bool))


@pytest.mark.parametrize("name,head", [("ResNet9", "linear"),
                                       ("ResNet18", "classifier"),
                                       ("ResNet101LN", None)])
def test_finetune_groups_equal_jax(name, head):
    """The head trains at 1.0, the rest at 0; the resnets' ``fc`` head is
    missed by the JAX package's mask, so their head mask is empty."""
    params, _, layout = _pair(name)
    args = _Args(name, True)
    jg = jcv.build_param_groups(args, params)
    tg = tcv.build_param_groups(args, layout)
    _groups_equal(jg, tg)
    (hmask, hbase), (rmask, rbase) = tg
    assert (hbase, rbase) == (1.0, 0.0)
    if head is None:
        assert not hmask.any() and rmask.all()
    else:
        want = np.zeros(layout.d, bool)
        for e in layout.entries:
            if e.jax_path[0] == head:
                want[e.offset:e.offset + e.size] = True
        np.testing.assert_array_equal(hmask, want)
    assert tcv.build_param_groups(_Args(name, False), layout) is None


def test_load_matching_equal_jax(tmp_path):
    """A CIFAR100 ResNet9 checkpoint into a ResNet9 with a 10-class head:
    every leaf but ``linear/kernel`` loads, in both packages."""
    src, _, _ = _pair("ResNet9")
    src = jax.tree_util.tree_map(np.asarray, src)
    big = jmodels.ResNet9(channels=TINY, num_classes=100)
    ckpt = jax.tree_util.tree_map(np.asarray, big.init(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)), train=False)["params"])
    j_save_checkpoint(str(tmp_path / "ResNet9"), ckpt)
    jckpt, _ = j_load_checkpoint(str(tmp_path / "ResNet9"))
    jtree, jloaded, jskipped = j_load_matching(src, jckpt)
    ttree, tloaded, tskipped = load_matching(src, jckpt)
    assert tloaded == jloaded == 8
    assert set(tskipped) == set(jskipped) == {"linear/kernel"}
    jax.tree_util.tree_map(np.testing.assert_array_equal, ttree,
                           jax.tree_util.tree_map(np.asarray, jtree))
    np.testing.assert_array_equal(ttree["prep"]["Conv_0"]["kernel"],
                                  ckpt["prep"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(ttree["linear"]["kernel"],
                                  src["linear"]["kernel"])


def test_finetune_init_loads_the_backbone(tmp_path):
    """``cv_train.finetune_init``: the fresh init from ``--seed`` with the
    checkpoint's matching leaves over it."""
    big = tmodels.ResNet9(channels=TINY, num_classes=100)
    big_layout = ParamLayout(big)
    from commefficient_torch.federated.aggregator import init_model_
    from commefficient_torch.federated.checkpoint import save_checkpoint

    init_model_(big, 5)
    ckpt = flax_from_port(dict(big.named_parameters()), big_layout)
    save_checkpoint(str(tmp_path / "ResNet9"), ckpt)
    args = t_parse(argv=["--model", "ResNet9", "--finetune",
                         "--finetuned_from", "CIFAR100", "--finetune_path",
                         str(tmp_path), "--dataset_name", "CIFAR10",
                         "--device", "cpu", "--seed", "0"])
    model = tmodels.ResNet9(channels=TINY, new_num_classes=10,
                            num_classes=100)
    layout = ParamLayout(model)
    flat = tcv.finetune_init(args, model, layout).numpy()
    fresh = tmodels.ResNet9(channels=TINY, new_num_classes=10)
    init_model_(fresh, 0)
    fresh_flat = layout.flatten(dict(fresh.named_parameters())).numpy()
    for e in layout.entries:
        got = flat[e.offset:e.offset + e.size]
        if e.jax_path[0] == "linear":
            np.testing.assert_array_equal(
                got, fresh_flat[e.offset:e.offset + e.size])
        else:
            node = ckpt
            for k in e.jax_path:
                node = node[k]
            np.testing.assert_array_equal(got, np.asarray(node).reshape(-1))


# -- FedOptimizer with groups ----------------------------------------------

COMMON = ["--k", "500", "--num_cols", "2048", "--num_rows", "3",
          "--num_blocks", "2", "--num_devices", "1",
          "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
          "--seed", "0", "--no_telemetry", "--num_workers", str(W),
          "--model", "FixupResNet9"]
MODES = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.9",
               "--local_batch_size", str(B)],
    "sketch-fused": ["--mode", "sketch", "--error_type", "virtual",
                     "--local_momentum", "0", "--virtual_momentum", "0.9",
                     "--local_batch_size", str(B), "--fused_epilogue"],
    "uncompressed": ["--mode", "uncompressed", "--error_type", "none",
                     "--local_momentum", "0", "--virtual_momentum", "0.9",
                     "--local_batch_size", str(B)],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--local_momentum", "0", "--local_batch_size", "-1",
               "--fedavg_batch_size", "2"],
}


def _batch(seed=100):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": np.ones((W, B), np.float32),
            "client_ids": np.array([0, 1, 2, 3], np.int32),
            "worker_mask": np.ones(W, np.float32)}


def _optimizers(mode):
    argv = COMMON + MODES[mode]
    jargs = j_parse(argv=argv)
    jm = jmodels.FixupResNet9(channels=TINY)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    assert jfm.mesh is None or jfm.mesh.devices.size == 1
    # seeded noise over Fixup's zero convs and head, so every group moves
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])
    flat0 = (flat0 + 0.05 * np.random.RandomState(3).randn(flat0.size)
             ).astype(np.float32)
    unravel = ravel_pytree(jfm.params)[1]
    jfm2 = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                     num_clients=NCLIENTS, init_params=unravel(
                         jnp.asarray(flat0)))
    jgroups = jcv.build_param_groups(jargs, jfm2.params)
    jopt = JFedOptimizer(jfm2, jargs, param_groups=jgroups)

    targs = t_parse(argv=argv + ["--device", "cpu"])
    tm = tmodels.FixupResNet9(channels=TINY)
    layout = ParamLayout(tm)
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=NCLIENTS,
                   init_params=flat_from_jax(flat0, layout), device="cpu")
    topt = FedOptimizer(tfm, targs,
                        param_groups=tcv.build_param_groups(targs, layout))
    return jfm2, jopt, tfm, topt, flat0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_vector_lr_and_one_round_match(mode):
    jfm, jopt, tfm, topt, flat0 = _optimizers(mode)
    jsched = JLambdaLR(jopt, lambda step: LR * (step + 1))
    tsched = LambdaLR(topt, lambda step: LR * (step + 1))
    assert tsched.get_last_lr() == jsched.get_last_lr() == pytest.approx(
        [0.01, 0.01, 0.1])
    jlr, tlr = np.asarray(jopt.get_lr()), topt.get_lr().numpy()
    assert tlr.shape == jlr.shape
    np.testing.assert_array_equal(tlr, jlr)
    if mode.startswith("sketch"):
        lay = tfm.layout
        assert tlr.shape == lay.shape
        # the padded tail carries LR 0: its coordinates never move
        flat = tlr.reshape(-1)
        assert not flat[lay.d:].any() and flat[:lay.d].all()
    # fedavg's clients take the vector
    assert tfm._opt_lr is topt.get_lr()
    b = _batch()
    jres = jfm(b)
    jopt.step()
    tres = tfm(b)
    topt.step()
    np.testing.assert_allclose(tres[0], jres[0], rtol=1e-4)
    jw = np.asarray(ravel_pytree(jfm.params)[0])
    tw = (tfm.layout.unchunk(tfm.ps_weights) if tfm.layout is not None
          else tfm.ps_weights).numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
    jmoved, tmoved = jw != flat0, tw != flat0
    overlap = (jmoved & tmoved).sum() / max(jmoved.sum(), tmoved.sum())
    assert overlap >= 0.99


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
def test_sketch_server_step_with_vector_lr_exact(fused):
    """From one table and state, the sketch rule with the chunked LR
    vector: the kept set exactly, values to rtol 1e-6."""
    mode = "sketch-fused" if fused else "sketch"
    jfm, jopt, tfm, topt, _ = _optimizers(mode)
    jopt.set_lr_factor(LR)
    topt.set_lr_factor(LR)
    js, ts = jfm.sketch, tfm.sketch
    rng = np.random.RandomState(1)
    g, vel, err = (rng.randn(*ts.table_shape).astype(np.float32)
                   for _ in range(3))
    jcfg = jsrv.ServerConfig(mode="sketch", error_type="virtual", k=500,
                             grad_size=tfm.grad_size, virtual_momentum=0.9,
                             fused_epilogue=fused)
    tcfg = tsrv.ServerConfig(mode="sketch", error_type="virtual", k=500,
                             grad_size=tfm.grad_size, virtual_momentum=0.9,
                             fused_epilogue=fused)
    jupd, jst = jsrv.server_update(
        jnp.asarray(g), jsrv.ServerState(jnp.asarray(vel), jnp.asarray(err)),
        jcfg, jopt.get_lr(), sketch=js, layout=js.chunk_layout)
    tupd, tst = tsrv.server_update(
        torch.from_numpy(g),
        tsrv.ServerState(torch.from_numpy(vel), torch.from_numpy(err)),
        tcfg, topt.get_lr(), sketch=ts, layout=ts.chunk_layout)
    jupd = np.asarray(jupd)
    np.testing.assert_array_equal(tupd.numpy() != 0, jupd != 0)
    np.testing.assert_allclose(tupd.numpy(), jupd, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tst.error.numpy(), np.asarray(jst.error),
                               rtol=1e-6, atol=1e-7)
    # the tail stays zero, and the groups' LRs are in the update
    flat = tupd.numpy().reshape(-1)
    assert not flat[tfm.grad_size:].any()


@pytest.mark.parametrize("mode", ["uncompressed", "fedavg"])
def test_frozen_coordinates_do_not_move(mode):
    """Finetune groups on ResNet9: only ``linear`` moves, in both
    packages (fedavg's clients apply the vector)."""
    argv = [a for a in COMMON if a != "FixupResNet9"]
    argv[argv.index("--model") + 1:argv.index("--model") + 1] = ["ResNet9"]
    argv += MODES[mode]
    jargs = j_parse(argv=argv)
    jm = jmodels.ResNet9(channels=TINY)
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])
    jargs.do_finetune = True
    jopt = JFedOptimizer(jfm, jargs,
                         param_groups=jcv.build_param_groups(jargs,
                                                             jfm.params))
    targs = t_parse(argv=argv + ["--device", "cpu"])
    targs.do_finetune = True
    tm = tmodels.ResNet9(channels=TINY)
    layout = ParamLayout(tm)
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=NCLIENTS,
                   init_params=flat_from_jax(flat0, layout), device="cpu")
    topt = FedOptimizer(tfm, targs,
                        param_groups=tcv.build_param_groups(targs, layout))
    jopt.set_lr_factor(LR)
    topt.set_lr_factor(LR)
    b = _batch(7)
    jfm(b)
    jopt.step()
    tfm(b)
    topt.step()
    jw = np.asarray(ravel_pytree(jfm.params)[0])
    tw = tfm.ps_weights.numpy()
    head = np.zeros(layout.d, bool)
    for e in layout.entries:
        if e.jax_path[0] == "linear":
            head[e.offset:e.offset + e.size] = True
    np.testing.assert_array_equal(tw[~head], flat0[~head])
    np.testing.assert_array_equal(jw[~head], flat0[~head])
    assert (tw[head] != flat0[head]).mean() > 0.5
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
