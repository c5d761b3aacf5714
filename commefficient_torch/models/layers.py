"""Shared layers: the port of ``commefficient_tpu/models/layers.py``.

Modules compute in PyTorch's NCHW layout. ResNet9's init is PyTorch's own
default for ``nn.Conv2d``/``nn.Linear`` (kaiming_uniform(a=sqrt(5)), i.e.
Uniform(+-1/sqrt(fan_in))), which is the distribution the JAX package's
``torch_conv_init`` reproduces; the other CV models (``FlaxPathed``) draw
each leaf from the JAX package's own initializer (Fixup's, the resnets'
kaiming normal, flax's ``lecun_normal``). Weights carried across from the
JAX package come in through ``commefficient_torch/convert.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from commefficient_torch.ops.flat import torch_to_jax_layout


@torch.no_grad()
def torch_conv_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv/linear weight from PyTorch's default
    Uniform(+-1/sqrt(fan_in)) with an explicit generator (the module
    constructors draw from the global one)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            bound = 1.0 / fan_in ** 0.5
            w.copy_(torch.empty(w.shape, dtype=w.dtype).uniform_(
                -bound, bound, generator=generator))


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping max-pool (VALID: a ragged edge is dropped, as in
    flax's ``nn.max_pool`` with strides equal to the window)."""
    return F.max_pool2d(x, window, stride=window)


BN_MOMENTUM = 0.9   # flax's: the weight of the OLD running statistic
BN_EPSILON = 1e-5


class BNContext:
    """The BatchNorm statistics one forward pass reads and writes:
    ``state`` maps ``"<flax path>/BatchNorm_0/{mean,var}"`` to the running
    statistics; in train mode each BatchNorm puts its updated running
    statistics into ``new`` under the same keys."""

    def __init__(self, state, train: bool):
        self.state = state
        self.train = bool(train)
        self.new = {}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an NCHW map, computed functionally (no buffers, nothing
    updated in place, so it runs under ``torch.func.vmap``).

    Train mode normalizes with the batch's statistics, as flax computes
    them: ``mean = E[x]``, ``var = max(0, E[x^2] - mean^2)`` (the biased
    variance, flax's fast variance), over every row of the batch, padding
    rows included; the running update is ``0.9 * old + 0.1 * batch`` for
    both (torch's ``momentum`` is the weight of the new statistic, and its
    running variance takes the unbiased one). Eval mode normalizes with
    the running statistics. ``y = (x - mean) * (rsqrt(var + eps) * scale)
    + bias``, in flax's order. ``path`` is the flax path of the module
    that holds it, ``name`` its own flax name (``BatchNorm_0`` when flax
    names it, ``bn1`` in ResNet18's blocks)."""

    def __init__(self, c: int, path, name: str = "BatchNorm_0"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.flax_path = tuple(path) + (name,)
        self.flax_leaves = {"scale": ("scale", "asis", "ones"),
                            "bias": ("bias", "asis", "zeros")}
        self.key = "/".join(self.flax_path)

    def initial_state(self):
        c = self.scale.shape[0]
        return {self.key + "/mean": torch.zeros(c),
                self.key + "/var": torch.ones(c)}

    def forward(self, x, ctx: BNContext):
        if ctx.train:
            mean = x.mean(dim=(0, 2, 3))
            mean2 = (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            old_m = ctx.state[self.key + "/mean"]
            old_v = ctx.state[self.key + "/var"]
            ctx.new[self.key + "/mean"] = (BN_MOMENTUM * old_m
                                           + (1.0 - BN_MOMENTUM) * mean)
            ctx.new[self.key + "/var"] = (BN_MOMENTUM * old_v
                                          + (1.0 - BN_MOMENTUM) * var)
        else:
            # the float32 running statistics in the input's dtype (--bf16)
            mean = ctx.state[self.key + "/mean"].to(x.dtype)
            var = ctx.state[self.key + "/var"].to(x.dtype)
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        return y + self.bias[None, :, None, None]


class ConvBN(nn.Module):
    """3x3 conv without bias (+ BatchNorm under ``--batchnorm``) + ReLU +
    optional max-pool: the reference's ``ConvBN`` cell. ``path`` is the
    cell's flax path, which names its BatchNorm statistics."""

    def __init__(self, c_in: int, c_out: int, pool: int = 0,
                 do_batchnorm: bool = False, path=()):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.bn = BatchNorm(c_out, path) if do_batchnorm else None
        self.pool = pool

    def forward(self, x, ctx: BNContext = None):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, ctx)
        x = F.relu(x)
        if self.pool:
            x = max_pool(x, self.pool)
        return x


# -- the other CV models: flax-pathed leaves, Fixup and the resnets ---------
#
# Each parameterized module below names its flax path (``flax_path``) and,
# per parameter, its flax leaf name, layout kind (``ops/flat.LEAF_KINDS``)
# and the JAX package's initializer (``flax_leaves``). ``FlaxPathed``
# collects them, which fixes a model's flat vector in JAX ravel order and
# draws its init. Init specs, as the JAX package's ``models/layers.py``
# writes them: ``("normal_fan_out", s)`` is ``variance_scaling(s,
# "fan_out", "normal")`` (Fixup: s = 2 / L; ``kaiming_normal_fan_out``:
# s = 2), ``("uniform_fan_in", 1/3)`` PyTorch's default conv/linear init
# (``torch_conv_init``), ``("trunc_fan_in", 1.0)`` flax's default
# ``lecun_normal`` of an ``nn.Dense`` kernel (a normal truncated at +-2
# standard deviations), ``"zeros"`` and ``"ones"``.

def fixup_init(num_layers: float):
    return ("normal_fan_out", 2.0 / num_layers)


kaiming_normal_fan_out = ("normal_fan_out", 2.0)
torch_conv_init = ("uniform_fan_in", 1.0 / 3.0)
lecun_normal = ("trunc_fan_in", 1.0)

# flax's truncated-normal stddev correction: the standard deviation of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fans(jax_shape):
    """(fan_in, fan_out) of a leaf in its flax shape: conv kernels HWIO
    (the receptive field times I or O), dense kernels (in, out)."""
    if len(jax_shape) < 2:
        n = jax_shape[0] if jax_shape else 1
        return n, n
    rf = 1
    for s in jax_shape[:-2]:
        rf *= s
    return jax_shape[-2] * rf, jax_shape[-1] * rf


@torch.no_grad()
def draw_init_(p: torch.Tensor, init, jax_shape, generator: torch.Generator):
    """Fill ``p`` from the JAX package's initializer ``init`` (the specs
    above), drawn from ``generator``; fans from the leaf's flax shape."""
    if init == "zeros":
        p.zero_()
        return
    if init == "ones":
        p.fill_(1.0)
        return
    kind, scale = init
    fan_in, fan_out = _fans(tuple(jax_shape))
    if kind == "normal_fan_out":
        std = (scale / fan_out) ** 0.5
        p.copy_(torch.randn(p.shape, generator=generator) * std)
    elif kind == "uniform_fan_in":
        bound = (3.0 * scale / fan_in) ** 0.5
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))
    elif kind == "trunc_fan_in":
        std = (scale / fan_in) ** 0.5 / _TRUNC_STD
        t = torch.empty(p.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        p.copy_(t * std)
    else:
        raise ValueError(f"unknown init {init!r}")


class FlaxPathed(nn.Module):
    """Base of the models whose leaves declare their flax paths: the
    ``jax_param_path`` / ``jax_param_kind`` that ``ops/flat.ParamLayout``
    reads, ``init_`` (the JAX package's initializers, drawn in ravel
    order from one generator) and ``initial_model_state`` (the running
    statistics of every ``BatchNorm``; empty without one)."""

    do_batchnorm = False

    def _leaf_table(self):
        table = self.__dict__.get("_flax_leaf_table")
        if table is None:
            table = {}
            for mname, mod in self.named_modules():
                for pname, spec in getattr(mod, "flax_leaves", {}).items():
                    leaf, kind, init = spec
                    name = f"{mname}.{pname}" if mname else pname
                    table[name] = (tuple(mod.flax_path) + (leaf,), kind, init)
            self.__dict__["_flax_leaf_table"] = table
        return table

    def jax_param_path(self, torch_name: str) -> Tuple[str, ...]:
        return self._leaf_table()[torch_name][0]

    def jax_param_kind(self, torch_name: str) -> str:
        return self._leaf_table()[torch_name][1]

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """Every leaf from its JAX initializer, in JAX ravel order. (The
        two frameworks draw different numbers from one seed; weights
        cross through ``convert.py``.)"""
        table = self._leaf_table()
        params = dict(self.named_parameters())
        for name in sorted(table, key=lambda n: table[n][0]):
            path, kind, init = table[name]
            p = params[name]
            shape = tuple(torch_to_jax_layout(p, kind).shape)
            draw_init_(p, init, shape, generator)

    def initial_model_state(self) -> Dict[str, torch.Tensor]:
        state = {}
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                state.update(mod.initial_state())
        return dict(sorted(state.items()))

    def _wrap_out(self, logits, ctx, model_state, train):
        """``logits``; with BatchNorm ``(logits, new_model_state)`` (in
        train mode the updated running statistics, in eval mode
        ``model_state`` itself), as ResNet9 returns them."""
        if not self.do_batchnorm:
            return logits
        return logits, (dict(sorted(ctx.new.items())) if train
                        else model_state)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` without a bias: an OIHW ``nn.Conv2d`` whose kernel
    is the flax leaf ``<path>/kernel``. ``padding`` is explicit (flax's
    ``SAME`` of the 1x1 convs is no padding)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, path=(),
                 init=kaiming_normal_fan_out):
        super().__init__(c_in, c_out, k, stride=stride, padding=padding,
                         groups=groups, bias=False)
        self.flax_path = tuple(path)
        self.flax_leaves = {"weight": ("kernel", "conv", init)}


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``<path>/kernel`` (in, out) and ``<path>/bias``
    (zeros)."""

    def __init__(self, c_in: int, c_out: int, path=(), init=lecun_normal):
        super().__init__(c_in, c_out, bias=True)
        self.flax_path = tuple(path)
        self.flax_leaves = {"weight": ("kernel", "dense", init),
                            "bias": ("bias", "asis", "zeros")}


class ScalarAdd(nn.Module):
    """Learned scalar bias (Fixup's ``Add``): ``<path>/bias`` of shape
    (1,), zeros."""

    def __init__(self, path=()):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1))
        self.flax_path = tuple(path)
        self.flax_leaves = {"bias": ("bias", "asis", "zeros")}

    def forward(self, x):
        return x + self.bias


class ScalarMul(nn.Module):
    """Learned scalar scale (Fixup's ``Mul``): ``<path>/scale`` of shape
    (1,), ones."""

    def __init__(self, path=()):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.flax_path = tuple(path)
        self.flax_leaves = {"scale": ("scale", "asis", "ones")}

    def forward(self, x):
        return x * self.scale


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes of an NCHW map -> (N, C)."""
    return x.mean(dim=(2, 3))


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Max over the spatial axes of an NCHW map -> (N, C)."""
    return x.amax(dim=(2, 3))


LN_EPSILON = 1e-6   # flax's nn.LayerNorm default (torch's is 1e-5)


class LayerNorm2d(nn.Module):
    """flax ``nn.LayerNorm(reduction_axes=(-3, -2, -1))`` of an NHWC map,
    on the port's NCHW one: statistics over (C, H, W) of each example,
    the affine ``scale``/``bias`` of shape (C,) on the channel axis only
    (flax's feature axis -1), epsilon 1e-6, flax's fast variance
    ``max(0, E[x^2] - E[x]^2)`` reduced in float32, and ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in flax's order. Not torch's
    ``nn.LayerNorm``. Computed functionally, so it runs under
    ``torch.func.vmap``. ``path`` is the ``LayerNorm2d`` module's flax
    path; its leaves sit under ``<path>/LayerNorm_0``."""

    def __init__(self, c: int, path=()):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.flax_path = tuple(path) + ("LayerNorm_0",)
        self.flax_leaves = {"scale": ("scale", "asis", "ones"),
                            "bias": ("bias", "asis", "zeros")}

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        mean2 = (xf * xf).mean(dim=(1, 2, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LN_EPSILON) * self.scale.to(
            torch.float32)[None, :, None, None]
        y = (xf - mean) * mul + self.bias.to(torch.float32)[None, :, None,
                                                             None]
        return y.to(x.dtype)
