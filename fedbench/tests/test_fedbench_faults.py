"""A run with the timed path broken underneath reads ``correct`` false:
a step that returns its state unchanged, half of the batch left out with
the mean taken over the rest, and a client's loss altered where it is
produced. (One card: no exchange between chips to leave out.)"""

import numpy as np
import pytest

from commefficient_torch.federated import aggregator
from fedbench import harness, spec
from fedbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("root"))


def _run(root, name):
    return harness.run(spec.cell(name, root), 9, 0.2, False, device="cpu")


def _step_unchanged(monkeypatch):
    monkeypatch.setattr(aggregator.FedOptimizer, "step", lambda self: None)


def _half_batch(monkeypatch):
    begin = aggregator.FedModel.begin_round

    def half(self, batch):
        batch = dict(batch)
        W = len(batch["worker_mask"])
        wm = np.asarray(batch["worker_mask"]).copy()
        wm[W - W // 2:] = 0
        batch["worker_mask"] = wm
        batch["mask"] = np.asarray(batch["mask"]) * wm[:, None]
        return begin(self, batch)

    monkeypatch.setattr(aggregator.FedModel, "begin_round", half)


def _loss_altered(monkeypatch):
    finish = aggregator.FedModel.finish_rounds

    def altered(self, handles, on_round=None):
        out = finish(self, handles, on_round)
        for values in out:
            values[0] = values[0] * np.float32(1.001)
        return out

    monkeypatch.setattr(aggregator.FedModel, "finish_rounds", altered)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(root, name):
    out = _run(root, name)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch,
                                   _loss_altered])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_fault_is_not_correct(root, name, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(root, name)
    assert out["correct"] is False, out["checks"]
