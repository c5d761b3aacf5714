"""ResNet9 (the Myrtle / DAWNBench CIFAR10 network of the FetchSGD
reference's ``models/resnet9.py``) in plain PyTorch over flax-layout
leaves.

prep conv -> layer1 conv + pool -> residual of two convs -> layer2 conv +
pool -> layer3 conv + pool -> residual of two convs -> global max-pool ->
bias-free linear -> x ``output_scale``. Every conv is 3 x 3, stride 1,
padding 1, without bias, followed by ReLU (no BatchNorm, as the FetchSGD
recipe runs it); a pool is a non-overlapping 2 x 2 max-pool; a residual is
``x + relu(conv(relu(conv(x))))``. The per-example loss is the
cross-entropy of the logits.
"""

from __future__ import annotations

import math

from torch.nn import functional as F

# the traffic field whose per-client shape sizes the model's work
MAIN_FIELD = "inputs"

_CELLS = (("prep", None), ("layer1", "prep"), ("res1", "layer1"),
          ("layer2", "layer1"), ("layer3", "layer2"), ("res3", "layer3"))


def _conv_paths(cfg):
    ch = cfg["channels"]
    c_in = {None: cfg["image_channels"]}
    c_in.update(ch)
    out = []
    for name, src in _CELLS:
        if name.startswith("res"):
            c = ch[src]
            for sub in ("res1", "res2"):
                out.append(((name, sub, "Conv_0", "kernel"), (3, 3, c, c)))
        else:
            out.append(((name, "Conv_0", "kernel"),
                        (3, 3, c_in[src], ch[name])))
    return out


def leaves(cfg):
    """``[(flax path, flax shape)]`` of the model's parameters."""
    return _conv_paths(cfg) + [
        (("linear", "kernel"), (cfg["channels"]["layer3"],
                                cfg["num_classes"]))]


def init_rule(path, shape, cfg):
    """PyTorch's default conv and linear init: Uniform(+-1/sqrt(fan_in)),
    the fan-in being every axis of the flax kernel but the last."""
    return ("uniform", 1.0 / math.sqrt(math.prod(shape[:-1])))


def _cell(x, kernel, pool=False):
    y = F.relu(F.conv2d(x, kernel.permute(3, 2, 0, 1), padding=1))
    return F.max_pool2d(y, 2, stride=2) if pool else y


def forward(params, images, cfg):
    """Logits ``(N, num_classes)`` of NHWC float32 images."""
    def k(*path):
        return params[path + ("Conv_0", "kernel")]

    x = images.permute(0, 3, 1, 2)
    x = _cell(x, k("prep"))
    x = _cell(x, k("layer1"), pool=True)
    x = x + _cell(_cell(x, k("res1", "res1")), k("res1", "res2"))
    x = _cell(x, k("layer2"), pool=True)
    x = _cell(x, k("layer3"), pool=True)
    x = x + _cell(_cell(x, k("res3", "res1")), k("res3", "res2"))
    x = F.max_pool2d(x, min(4, x.shape[2]))
    x = x.reshape(x.shape[0], -1)
    return (x @ params[("linear", "kernel")]) * cfg["output_scale"]


def keep_numel(cfg, batch) -> int:
    """No dropout: a client draws no keep masks."""
    return 0


def example_losses(params, batch, keep, cfg):
    """``(W, B)`` cross-entropy of every example of every client;
    ``batch`` holds ``inputs (W, B, H, W, C)`` and ``targets (W, B)``."""
    x = batch["inputs"]
    W, B = x.shape[:2]
    logits = forward(params, x.reshape((W * B,) + tuple(x.shape[2:])), cfg)
    ce = F.cross_entropy(logits, batch["targets"].reshape(-1).long(),
                         reduction="none")
    return ce.reshape(W, B)


def train_flops(cfg, per_client_shape) -> float:
    """Model FLOPs of one example's forward and backward, counted from
    the shapes with nothing recomputed: each conv ``2 H W 9 C_in C_out``
    at its output size and the linear ``2 C K``, the backward twice the
    forward but for the first conv, whose input (the images) needs no
    gradient."""
    ch = cfg["channels"]
    side = int(per_client_shape[1])
    sides = {"prep": side, "layer1": side, "res1": side // 2,
             "layer2": side // 2, "layer3": side // 4, "res3": side // 8}
    c_in = {None: cfg["image_channels"]}
    c_in.update(ch)
    fwd, first = 0.0, None
    for name, src in _CELLS:
        s = sides[name]
        if name.startswith("res"):
            c = ch[src]
            fwd += 2 * (2.0 * s * s * 9 * c * c)
        else:
            f = 2.0 * s * s * 9 * c_in[src] * ch[name]
            fwd += f
            if first is None:
                first = f
    fwd += 2.0 * ch["layer3"] * cfg["num_classes"]
    return 3.0 * fwd - first
