"""The numbers that decide ``correct``, on hand-made readings: which cells
the first gradient's comparison takes, the cells zeroed by one side
alone, and the first round's losses apart from the later rounds'."""

import numpy as np
import pytest
import torch

from fedbench import calibrate, check, spec
from fedbench.reference.flat import Layout
from fedbench.tests import tiny

LAYOUT = Layout([(("a",), (4,)), (("b",), (4,))])
W0 = torch.zeros(8)


def _side(velocity, losses=((1.0, 2.0), (1.0, 2.0)), weights=None):
    return {"losses": np.array(losses), "velocity": velocity,
            "weights": torch.ones(8) if weights is None else weights,
            "grad_leaf_norms": np.ones(2)}


def _numbers(prog, ref):
    return check.numbers(prog, ref, LAYOUT, W0)


def test_sound_reads_zero_everywhere():
    table = torch.arange(1.0, 9.0).reshape(2, 4)
    table[0, 1] = 0
    got = _numbers(_side(table.clone()), _side(table))
    assert got == {"first_loss_gap": 0.0, "loss_gap": 0.0, "grad_gap": 0.0,
                   "zeroed_differ": 0, "change_gap": 0.0}


def test_cells_one_side_zeroed_are_counted_the_rest_compared():
    ref = torch.full((2, 4), 2.0)
    prog = ref.clone()
    prog[1] = 0
    got = _numbers(_side(prog), _side(ref))
    assert got["grad_gap"] == 0.0 and got["zeroed_differ"] == 4
    prog[0, 0] = 4.0
    assert _numbers(_side(prog), _side(ref))["grad_gap"] > 0.1


def test_a_cell_the_reference_alone_zeroed_is_counted_not_compared():
    ref = torch.full((2, 4), 2.0)
    ref[0, 0] = 0
    prog = torch.full((2, 4), 2.0)
    got = _numbers(_side(prog), _side(ref))
    assert got["grad_gap"] == 0.0 and got["zeroed_differ"] == 1


def test_dense_velocity_is_compared_whole():
    ref = torch.full((8,), 3.0)
    prog = ref.clone()
    prog[4:] = 0
    got = _numbers(_side(prog), _side(ref))
    assert got["grad_gap"] == 1.0 and "zeroed_differ" not in got


def test_first_round_losses_apart_from_the_later_rounds():
    v = torch.ones(8)
    got = _numbers(_side(v, losses=((1.0, 2.002), (1.0, 2.0))), _side(v))
    assert got["first_loss_gap"] == pytest.approx(1e-3)
    assert got["loss_gap"] == 0.0
    got = _numbers(_side(v, losses=((1.0, 2.0), (1.1, 2.0))), _side(v))
    assert got["first_loss_gap"] == 0.0
    assert got["loss_gap"] == pytest.approx(0.1)


def test_verdict_fails_a_number_over_its_limit_or_missing():
    limits = {n: 0.5 for n in check.NAMES}
    ok, out = check.verdict({n: 0.1 for n in check.NAMES}, limits)
    assert ok and list(out) == list(check.NAMES)
    assert not check.verdict({**{n: 0.1 for n in check.NAMES},
                              "zeroed_differ": 1}, limits)[0]
    assert not check.verdict({"loss_gap": 0.1}, limits)[0]
    assert not check.verdict({"loss_gap": 0.1}, {})[0]


def _reading(sound, control, half):
    return {"workload": "w", "seed": 0, "sound": sound, "control": control,
            "half_batch": half}


def test_limits_lie_between_the_sound_and_the_failing_readings():
    sound = [{"first_loss_gap": 0.0, "loss_gap": 1e-4, "grad_gap": 1e-9,
              "zeroed_differ": 0, "change_gap": 4e-3}] * 3
    control = {"first_loss_gap": 2e-5, "loss_gap": 2e-4, "grad_gap": 5e-6,
               "zeroed_differ": 3000, "change_gap": 5e-2}
    half = {"first_loss_gap": 1.0, "loss_gap": 1.0, "grad_gap": 0.3,
            "zeroed_differ": 10**6, "change_gap": 1.0}
    lines = [{"workload": "w", "seed": 0, "sound": s} for s in sound]
    lines.append(_reading(sound[0], control, half))
    got = calibrate.limits(lines)
    assert {k: v for k, v in got.items() if k != "set_from"} == {
        "first_loss_gap": 2e-6, "loss_gap": 0.02, "grad_gap": 2e-7,
        "zeroed_differ": 200, "change_gap": 0.02}
    assert got["set_from"]["loss_gap"]["upper_from"] == \
        "half of the batch left out"
    for name, f in got["set_from"].items():
        assert f["lower"] < got[name] < f["upper"]
    with pytest.raises(ValueError, match="loss_gap"):
        calibrate.limits(lines + [_reading(
            sound[0], control, {**half, "loss_gap": 5e-4})])


def test_compression_mode_is_set_in_one_layer(tmp_path):
    root = tiny.make(tmp_path)
    c = spec.cell("t-gpt2-dense", root)
    assert c.recipe["mode"] == "uncompressed"
    assert "mode" not in c.config["recipe"]
    c.config["recipe"]["mode"] = "sketch"
    with pytest.raises(ValueError, match="mode"):
        c.recipe


def test_a_mix_extends_another_by_name():
    sketch = spec.mix("persona-w4-sketch")
    dense = spec.mix("persona-w4-uncompressed")
    assert "extends" not in dense
    assert dense["fields"] == sketch["fields"]
    assert dense["recipe"] == {"mode": "uncompressed", "error_type": "none"}
    assert sketch["recipe"]["mode"] == "sketch"
