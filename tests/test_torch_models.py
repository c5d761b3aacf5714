"""The port's ResNet9 and weight conversion against the JAX package on the
CPU: JAX-initialised parameters carried across with
``commefficient_torch/convert.py`` give the same logits and the same flat
gradient in JAX ravel order.

Tolerance: float32 convolutions in XLA and in PyTorch's CPU backend sum in
different orders, so logits and gradients agree to about 1e-6 relative;
``rtol=1e-4, atol=1e-5`` leaves room for the depth of the network.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    flax_from_port,
    params_from_flax,
)
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models import ResNet9 as TResNet9  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", params=[(32, 3, 10), (28, 1, 62)],
                ids=["cifar", "emnist"])
def pair(request):
    hw, cin, ncls = request.param
    jm = JResNet9(channels=TINY, num_classes=ncls, initial_channels=cin)
    params = jm.init(jax.random.key(0), jnp.zeros((1, hw, hw, cin)),
                     train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = TResNet9(channels=TINY, num_classes=ncls, initial_channels=cin)
    return jm, params, tm, ParamLayout(tm), (hw, cin, ncls)


def test_flat_layout_is_jax_ravel_order(pair):
    jm, params, tm, layout, _ = pair
    flat, _ = ravel_pytree(params)
    assert layout.d == flat.size
    names = ["/".join(p) for p in (e.jax_path for e in layout.entries)]
    assert names == [
        "layer1/Conv_0/kernel", "layer2/Conv_0/kernel",
        "layer3/Conv_0/kernel", "linear/kernel", "prep/Conv_0/kernel",
        "res1/res1/Conv_0/kernel", "res1/res2/Conv_0/kernel",
        "res3/res1/Conv_0/kernel", "res3/res2/Conv_0/kernel"]
    # the flat vector of the converted tree is the JAX flat vector
    tparams = params_from_flax(params, layout)
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(),
                                  np.asarray(flat))
    # and its views are the converted leaves
    views = layout.params(flat_from_jax(np.asarray(flat), layout))
    for name, t in tparams.items():
        np.testing.assert_array_equal(views[name].numpy(), t.numpy())


def test_round_trip(pair):
    _, params, _, layout, _ = pair
    back = flax_from_port(params_from_flax(params, layout), layout)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))


def test_full_width_d():
    """Full-width CIFAR ResNet9 has the headline d = 6,568,640."""
    assert ParamLayout(TResNet9()).d == 6_568_640


def _batch(hw, cin, ncls, n=6, seed=0):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(n, hw, hw, cin).astype(np.float32),
            "targets": rng.randint(0, ncls, size=n).astype(np.int64),
            "mask": np.array([1, 1, 1, 1, 0, 1], np.float32)[:n]}


def test_logits_match(pair):
    jm, params, tm, layout, (hw, cin, ncls) = pair
    b = _batch(hw, cin, ncls)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(b["inputs"]),
                               train=False))
    got = torch.func.functional_call(
        tm, params_from_flax(params, layout),
        (torch.from_numpy(b["inputs"]),)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_loss_and_flat_gradient_match(pair):
    jm, params, tm, layout, (hw, cin, ncls) = pair
    b = _batch(hw, cin, ncls, seed=1)
    jtrain, _ = j_losses(jm)
    flat, unravel = ravel_pytree(params)

    def jloss(w):
        loss, (acc,), count, _ = jtrain(unravel(w), {},
                                        {k: jnp.asarray(v) for k, v in
                                         b.items()}, None, True)
        return loss, (acc, count)

    (jl, (jacc, jcount)), jg = jax.value_and_grad(jloss, has_aux=True)(flat)

    ttrain, _ = t_losses(tm)
    w = flat_from_jax(np.asarray(flat), layout).requires_grad_(True)
    tl, (tacc,), tcount, _ = ttrain(layout.params(w), {},
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()}, None, True)
    (tg,) = torch.autograd.grad(tl, w)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    assert float(tacc) == float(jacc) and float(tcount) == float(jcount)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)


def test_cv_train_model_widths(monkeypatch):
    from commefficient_torch import cv_train

    args = type("A", (), {"dataset_name": "CIFAR10", "model": "ResNet9"})()
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.delenv("COMMEFFICIENT_MODEL_CHANNELS", raising=False)
    assert ParamLayout(cv_train.build_model_and_config(args)).d == 31_640
    monkeypatch.setenv("COMMEFFICIENT_MODEL_CHANNELS", "12,24,48,96")
    assert ParamLayout(cv_train.build_model_and_config(args)).d == 231_972
    assert os.environ["COMMEFFICIENT_MODEL_CHANNELS"] == "12,24,48,96"
