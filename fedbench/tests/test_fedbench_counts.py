"""The yardstick's counts against hand counts and against PyTorch's own
FLOP counter at small shapes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench import counts
from fedbench.reference import gpt2_double_heads, resnet9
from fedbench.reference.flat import Layout, initial_weights
from fedbench.tests.tiny import REPO

R9 = {"channels": {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32},
      "image_channels": 3, "num_classes": 10, "output_scale": 0.125}
G2 = {"vocab_size": 96, "n_positions": 16, "n_embd": 16, "n_layer": 2,
      "n_head": 2, "resid_pdrop": 0.0, "embd_pdrop": 0.0, "attn_pdrop": 0.0,
      "layer_norm_epsilon": 1e-5, "initializer_range": 0.02}


def test_resnet9_flops_by_hand():
    conv = lambda s, a, b: 2 * s * s * 9 * a * b  # noqa: E731
    fwd = (conv(32, 3, 8) + conv(32, 8, 16) + 2 * conv(16, 16, 16)
           + conv(16, 16, 16) + conv(8, 16, 32) + 2 * conv(4, 32, 32)
           + 2 * 32 * 10)
    assert resnet9.train_flops(R9, [5, 32, 32, 3]) == 3 * fwd - conv(
        32, 3, 8)


def _measured(loss_fn, params):
    with FlopCounterMode(display=False) as fc:
        loss = loss_fn()
        torch.autograd.grad(loss, params)
    return fc.get_total_flops()


def test_resnet9_flops_match_torch_counter():
    layout = Layout(resnet9.leaves(R9))
    w = initial_weights(layout, resnet9.init_rule, R9, 0, "cpu")
    leaves = [t.detach().requires_grad_(True)
              for t in layout.split(w).values()]
    params = dict(zip(layout.paths, leaves))
    x = torch.randn(1, 3, 32, 32, 3)
    batch = {"inputs": x, "targets": torch.zeros(1, 3, dtype=torch.long)}
    got = _measured(lambda: resnet9.example_losses(params, batch, None,
                                                   R9).sum(), leaves)
    assert got == pytest.approx(3 * resnet9.train_flops(R9, [3, 32, 32, 3]),
                                rel=1e-6)


def test_gpt2_flops_by_hand_and_torch_counter():
    C, L, V, T, Cn = 16, 2, 96, 16, 2
    per_token = L * (24 * C * C + 4 * T * C) + 2 * C * V
    assert gpt2_double_heads.train_flops(G2, [1, Cn, T]) == \
        3 * per_token * Cn * T
    layout = Layout(gpt2_double_heads.leaves(G2))
    w = initial_weights(layout, gpt2_double_heads.init_rule, G2, 0, "cpu")
    leaves = [t.detach().requires_grad_(True)
              for t in layout.split(w).values()]
    params = dict(zip(layout.paths, leaves))
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, V, (1, 1, Cn, T), generator=g)
    batch = {"input_ids": ids, "token_type_ids": ids, "lm_labels": ids,
             "mc_token_ids": torch.full((1, 1, Cn), T - 1),
             "mc_labels": torch.zeros(1, 1, dtype=torch.long)}
    got = _measured(lambda: gpt2_double_heads.example_losses(
        params, batch, None, G2).sum(), leaves)
    # the counter adds the MC head's 2 C a sequence, forward and backward
    mc = 3 * 2 * C * Cn
    assert got == pytest.approx(gpt2_double_heads.train_flops(
        G2, [1, Cn, T]) + mc, rel=1e-9)


@pytest.mark.parametrize("name,d", [("gpt2-small-persona", 124_444_417),
                                    ("resnet9-cifar10", 6_568_640)])
def test_published_widths_give_the_published_d(name, d):
    with open(REPO / f"fedbench/configs/{name}.json") as f:
        cfg = json.load(f)
    ref = {"gpt2_double_heads": gpt2_double_heads,
           "resnet9": resnet9}[cfg["model"]]
    assert Layout(ref.leaves(cfg)).d == d == cfg["d"]


def test_kernel_work_by_hand():
    d, r, c_pad = 1000, 3, 256
    table, plane = 4 * r * c_pad, 4 * d
    assert counts.kernel_work("sketch_accumulate", d, r, c_pad) == {
        "bytes": plane + table, "int_ops": 7 * r * d, "flops": r * d}
    assert counts.kernel_work("sketch_estimates", d, r, c_pad) == {
        "bytes": table + plane, "int_ops": 7 * r * d,
        "flops": (r + r * (r - 1)) * d}
    assert counts.kernel_work("topk_count_ge", d, r, c_pad) == {
        "bytes": plane, "int_ops": 16 * d, "flops": 0.0}
    with pytest.raises(KeyError):
        counts.kernel_work("torch_topk", d, r, c_pad)


def test_bound_takes_the_slower_resource():
    peak = (1e12, 1e12, 1e12)
    assert counts.bound(2e9, 1e9, 0, peak) == {"bound_ms": 2.0,
                                               "bound_by": "bytes"}
    assert counts.bound(1e9, 0, 3e9, peak) == {"bound_ms": 3.0,
                                               "bound_by": "operations"}
