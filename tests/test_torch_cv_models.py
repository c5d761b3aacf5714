"""The port's other CV models against the JAX package on the CPU, at
reduced depth: ``ResNet(layers=(1, 1, 1, 1), norm="layer",
initial_channels=1, num_classes=62)`` for ResNet101LN, the resnets with
BatchNorm, a ResNeXt and a wide block, ``FixupResNet50(layers=(1, 1, 1,
1))``, FixupResNet9, FixupResNet18 and ResNet18.

For each: the port's leaf paths, layout kinds and shapes are those of the
JAX model's ``model.init`` tree, in ravel order; a JAX tree carried across
with ``convert.params_from_flax`` gives the JAX flat vector bit for bit;
logits and per-leaf gradients match. The init leaves are perturbed by
seeded noise first, so that Fixup's zero convs and heads and the scalars
carry signal. BatchNorm models: train-mode logits and the updated
``batch_stats`` against flax's ``mutable=["batch_stats"]``, and eval-mode
logits from the running statistics. LayerNorm: a large mean offset that
shows flax's fast variance, and an epsilon-sensitive case.

Tolerances: XLA's CPU convolutions and PyTorch's sum in different orders,
so logits, losses, gradients and statistics agree to about 1e-6 relative;
``rtol=1e-4, atol=1e-5`` leaves room for the depth (as
``tests/test_torch_models.py``); logits and a leaf's gradient take
``atol`` times their largest magnitude where that exceeds 1 (the
perturbed weights give values of a few units to a few tens, whose
summation error scales with them). A
normalization layer alone on the same input: ``rtol=1e-5, atol=1e-6``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu import models as jmodels  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models.layers import LayerNorm2d as JLayerNorm2d  # noqa: E402
from commefficient_torch import models as tmodels  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    flax_from_port,
    model_state_from_flax,
    params_from_flax,
)
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models.layers import LayerNorm2d  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))

# name: (model class name, kwargs, (H, W, C) input, classes, has BatchNorm)
CASES = {
    "resnet_ln": ("ResNet", dict(layers=(1, 1, 1, 1), norm="layer",
                                 initial_channels=1, num_classes=62),
                  (28, 28, 1), 62, False),
    "resnet_bn_basic": ("ResNet", dict(block="basic", layers=(1, 1, 1, 1),
                                       norm="batch", initial_channels=3,
                                       num_classes=10),
                        (32, 32, 3), 10, True),
    "resnet_bn_bottleneck": ("ResNet", dict(layers=(1, 1), norm="batch",
                                            initial_channels=1,
                                            num_classes=62),
                             (28, 28, 1), 62, True),
    "resnext": ("ResNet", dict(layers=(1, 1), norm="layer", groups=32,
                               width_per_group=4, initial_channels=1,
                               num_classes=62), (28, 28, 1), 62, False),
    "wide": ("ResNet", dict(layers=(1, 1), norm="layer",
                            width_per_group=128, initial_channels=1,
                            num_classes=62), (28, 28, 1), 62, False),
    "fixup50": ("FixupResNet50", dict(layers=(1, 1, 1, 1), num_classes=10),
                (32, 32, 3), 10, False),
    "fixup9": ("FixupResNet9", dict(channels=TINY, num_classes=62,
                                    initial_channels=1),
               (28, 28, 1), 62, False),
    "fixup9_cifar": ("FixupResNet9", dict(channels=TINY, num_classes=10),
                     (32, 32, 3), 10, False),
    "fixup18": ("FixupResNet18", dict(num_blocks=(1, 1, 1, 1),
                                      num_classes=10), (32, 32, 3), 10,
                False),
    "resnet18": ("ResNet18", dict(num_blocks=(1, 1, 1, 1), num_classes=10),
                 (32, 32, 3), 10, True),
}


def _port_kwargs(kw, hwc):
    """The port's constructor arguments: flax infers the stem's input
    channels from the batch, the port takes them as ``initial_channels``."""
    out = dict(kw)
    out["initial_channels"] = hwc[2]
    return out


def _perturb(tree, seed):
    """Init plus seeded noise on every leaf (N(0, 0.05) absolute, plus 5%
    of the leaf's own standard deviation)."""
    rng = np.random.RandomState(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        scale = 0.05 + 0.05 * float(x.std())
        return (x + scale * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name = request.param
    cls, kw, hwc, ncls, has_bn = CASES[name]
    jm = getattr(jmodels, cls)(**kw)
    variables = jm.init(jax.random.key(0), jnp.zeros((1,) + hwc),
                        train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray,
                                   variables.get("batch_stats", {}))
    tm = getattr(tmodels, cls)(**_port_kwargs(kw, hwc))
    return dict(name=name, jm=jm, params=params, stats=stats, tm=tm,
                layout=ParamLayout(tm), hwc=hwc, ncls=ncls, has_bn=has_bn)


def _batch(c, seed=0):
    """6 examples, one of them masked; 16 for the BatchNorm models, whose
    train-mode backward through the batch statistics loses float32
    precision in both packages on smaller batches."""
    n = 16 if c["has_bn"] else 6
    rng = np.random.RandomState(seed)
    mask = np.ones(n, np.float32)
    mask[4] = 0.0
    return {"inputs": rng.randn(n, *c["hwc"]).astype(np.float32),
            "targets": rng.randint(0, c["ncls"], size=n).astype(np.int64),
            "mask": mask}


def _path_str(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


def test_layout_is_the_jax_init_tree(case):
    """Leaf paths, kinds and shapes from ``model.init``, in ravel order; the
    converted tree's flat vector is the JAX flat vector bit for bit."""
    params, layout = case["params"], case["layout"]
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [e.jax_path for e in layout.entries] == [
        tuple(_path_str(p).split("/")) for p, _ in leaves]
    assert [e.jax_shape for e in layout.entries] == [
        tuple(x.shape) for _, x in leaves]
    for e, (path, x) in zip(layout.entries, leaves):
        want = ("conv" if x.ndim == 4 else
                "dense" if _path_str(path).endswith("kernel") else "asis")
        assert e.kind == want, (e.jax_path, e.kind)
    flat, _ = ravel_pytree(params)
    assert layout.d == flat.size
    tparams = params_from_flax(params, layout)
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(),
                                  np.asarray(flat))
    back = flax_from_port(tparams, layout)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    if case["has_bn"]:
        state = model_state_from_flax(case["stats"])
        assert sorted(state) == sorted(case["tm"].initial_model_state())
        for k, v in case["tm"].initial_model_state().items():
            np.testing.assert_array_equal(v.numpy(), state[k].numpy())
    else:
        assert case["tm"].initial_model_state() == {}


def test_init_follows_the_jax_initializers(case):
    """The port's ``init_`` draws each leaf from the JAX package's
    initializer: zeros and ones exactly, the random leaves of 2,000 or
    more entries with the JAX leaf's standard deviation within 8%."""
    tm, layout = case["tm"], case["layout"]
    tm.init_(torch.Generator().manual_seed(0))
    ported = flax_from_port(dict(tm.named_parameters()), layout)
    jl = dict((_path_str(p), np.asarray(x)) for p, x in
              jax.tree_util.tree_leaves_with_path(case["params"]))
    tl = dict((_path_str(p), np.asarray(x)) for p, x in
              jax.tree_util.tree_leaves_with_path(ported))
    assert sorted(jl) == sorted(tl)
    for k, want in jl.items():
        got = tl[k]
        if not want.any() or np.all(want == 1.0):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif want.size >= 2000:
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.08,
                                       err_msg=k)
            assert abs(got.mean()) < 0.1 * want.std() + 1e-6, k


def _run_jax(c, params, batch, train):
    jtrain, _ = j_losses(c["jm"], has_batch_stats=c["has_bn"])
    flat, unravel = ravel_pytree(params)

    def loss(w):
        ls, (acc,), count, new_state = jtrain(
            unravel(w), c["stats"], {k: jnp.asarray(v) for k, v in
                                     batch.items()}, None, train)
        return ls, (acc, count, new_state)

    (jl, (jacc, jcount, jstate)), jg = jax.value_and_grad(
        loss, has_aux=True)(flat)
    return float(jl), float(jacc), np.asarray(jg), jstate


def test_logits_match(case):
    params = _perturb(case["params"], 1)
    b = _batch(case)
    tparams = params_from_flax(params, case["layout"])
    x = torch.from_numpy(b["inputs"])
    variables = {"params": params}
    if case["has_bn"]:
        stats = _perturb(case["stats"], 2)
        stats = jax.tree_util.tree_map(np.abs, stats)  # variances > 0
        variables["batch_stats"] = stats
        state = model_state_from_flax(stats)
        want = np.asarray(case["jm"].apply(variables, jnp.asarray(
            b["inputs"]), train=False))
        got, same = torch.func.functional_call(case["tm"], tparams,
                                               (x, state, False))
        assert same is state
        # train mode: the batch's statistics, and the updated running ones
        want_t, upd = case["jm"].apply(variables, jnp.asarray(b["inputs"]),
                                       train=True, mutable=["batch_stats"])
        got_t, new = torch.func.functional_call(case["tm"], tparams,
                                                (x, state, True))
        want_t = np.asarray(want_t)
        np.testing.assert_allclose(
            got_t.detach().numpy(), want_t, rtol=RTOL,
            atol=ATOL * max(1.0, np.abs(want_t).max()))
        want_new = model_state_from_flax(jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"]))
        assert sorted(new) == sorted(want_new)
        for k in want_new:
            np.testing.assert_allclose(new[k].detach().numpy(),
                                       want_new[k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    else:
        want = np.asarray(case["jm"].apply(variables, jnp.asarray(
            b["inputs"]), train=False))
        got = torch.func.functional_call(case["tm"], tparams, (x,))
    got = got.detach().numpy()
    assert got.shape == want.shape == (len(b["mask"]), case["ncls"])
    assert np.abs(want).max() > 1e-3  # the perturbed heads carry signal
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_loss_and_leaf_gradients_match(case):
    """The train loss, accuracy and the gradient of every leaf (flat, in
    ravel order); BatchNorm models in train mode, with the updated
    running statistics against ``mutable=["batch_stats"]``."""
    params = _perturb(case["params"], 3)
    b = _batch(case, seed=4)
    jl, jacc, jg, jstate = _run_jax(case, params, b, True)
    layout = case["layout"]
    ttrain, _ = t_losses(case["tm"])
    flat, _ = ravel_pytree(params)
    w = flat_from_jax(np.asarray(flat), layout)
    leaves = layout.leaves(w)
    state = model_state_from_flax(case["stats"])
    tl, (tacc,), _, tstate = ttrain(
        layout.params_of(leaves), state,
        {k: torch.from_numpy(v) for k, v in b.items()}, None, True)
    grads = torch.autograd.grad(tl, leaves)
    tg = layout.gather_grads(grads, torch.empty(layout.d)).numpy()
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=RTOL)
    assert float(tacc) == jacc
    assert np.abs(jg).max() > 0
    for e in layout.entries:
        sl = slice(e.offset, e.offset + e.size)
        scale = max(1.0, float(np.abs(jg[sl]).max()))
        np.testing.assert_allclose(tg[sl], jg[sl], rtol=RTOL,
                                   atol=ATOL * scale,
                                   err_msg="/".join(e.jax_path))
    if case["has_bn"]:
        want = model_state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                            jstate))
        assert sorted(tstate) == sorted(want)
        for k in want:
            np.testing.assert_allclose(tstate[k].detach().numpy(),
                                       want[k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    else:
        assert tstate == state


@pytest.mark.parametrize("name,d,leaves", [
    ("ResNet101LN", 42_620_926, 314), ("FixupResNet50", 25_504_030, 173)])
def test_full_width_d(name, d, leaves):
    """The two full-width models: ResNet101-LN at FEMNIST's 1 x 28
    x 28, 62 classes, and the ImageNet FixupResNet50 (d and leaves from
    the JAX model's init tree)."""
    layout = ParamLayout(getattr(tmodels, name)())
    assert (layout.d, len(layout.entries)) == (d, leaves)


def _ln_pair(x_nhwc):
    c = x_nhwc.shape[-1]
    rng = np.random.RandomState(5)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    jln = JLayerNorm2d()
    want = np.asarray(jln.apply(
        {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}},
        jnp.asarray(x_nhwc)))
    tln = LayerNorm2d(c)
    with torch.no_grad():
        tln.scale.copy_(torch.from_numpy(scale))
        tln.bias.copy_(torch.from_numpy(bias))
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    got = tln(x).detach().permute(0, 2, 3, 1).numpy()
    # torch's own LayerNorm over (C, H, W): two-pass variance, eps 1e-5,
    # and a per-element affine; here with the channel affine broadcast
    ref = torch.nn.functional.layer_norm(x, x.shape[1:], eps=1e-5)
    ref = (ref * torch.from_numpy(scale)[None, :, None, None]
           + torch.from_numpy(bias)[None, :, None, None])
    return got, want, ref.permute(0, 2, 3, 1).numpy()


def test_layernorm_fast_variance_at_a_large_mean():
    """Integers near 1,000: every sum is exact in float32 in any order, so
    flax's fast variance ``E[x^2] - E[x]^2`` differs from the exact
    variance by the rounding of ``E[x]^2`` alone, the same in both
    packages; torch's two-pass ``nn.LayerNorm`` gives another answer."""
    rng = np.random.RandomState(6)
    x = (1000 + rng.randint(0, 4, (3, 2, 2, 4))).astype(np.float32)
    got, want, torch_ln = _ln_pair(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(torch_ln - want).max() > 1e-3


def test_layernorm_epsilon_is_flax_1e6():
    """A variance of about 1e-6: epsilon 1e-6 (flax) against 1e-5
    (torch) moves the output by a factor of about 2."""
    rng = np.random.RandomState(7)
    x = (1e-3 * rng.randn(3, 4, 4, 8)).astype(np.float32)
    got, want, torch_ln = _ln_pair(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(torch_ln - want).max() > 0.1 * np.abs(want).max()


def test_layernorm_runs_under_vmap():
    """Functional statistics: the port's LayerNorm2d runs under
    ``torch.func.vmap`` and equals the loop over the batch."""
    ln = LayerNorm2d(4)
    x = torch.randn(3, 2, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    got = torch.func.vmap(ln)(x)
    want = torch.stack([ln(xi) for xi in x])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
