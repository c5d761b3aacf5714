"""The ``learning_midscale`` uncompressed rung in the port against the JAX
package from equal weights, at the ``mid`` widths (24/48/96/192, d =
927,000 with the BatchNorm leaves) on the CPU.

Both ``FedModel``s start from the JAX package's initial weights and
BatchNorm statistics, take the first rounds of the leg's own loader
(``mid_uncompressed``: 8 clients x 16 images, ``--batchnorm``,
``--mode uncompressed --error_type virtual --virtual_momentum 0.9``, the
leg's LR schedule through each package's ``LambdaLR`` and round engine;
``tests/torch_learning_trace.py``), then evaluate on the leg's 60 test
images.

Tolerances. The JAX package's float32 gradient on the CPU is 2.4e-3 (in
relative L2) from its own float64 gradient at these weights and batch,
the port's 1.7e-6; the two packages' float64 gradients agree to 7e-8
(``torch_learning_trace.py --grad_check``). So the two runs part from
the first round by JAX's own float32 error, not by the math, and:

- the losses hold the trajectory tests' ``rtol=1e-4`` for these rounds
  and the accuracies are equal;
- the first round's update (the change of the weights) is within 5e-3
  of JAX's in relative L2, about twice JAX's float32 gradient error
  (measured: 2.3e-3), and the bound grows 4 times a round as the weights
  part (measured: 5.8e-3, 2.9e-2 in rounds 2 and 3); the element-wise
  ``rtol=1e-4, atol=1e-6`` of ``test_torch_batchnorm.py`` does not hold
  even after the first round (3.6 times over);
- the BatchNorm running statistics agree to ``rtol=1e-3, atol=1e-4``,
  ten times the trajectory tests' (they follow the weights);
- the evaluation's mean loss to ``rtol=1e-4`` and its accuracy exactly.

The three rounds and the eval take about 35 s on an idle 8-core host
(125 s with other jobs running), nearly all of it the JAX package's
rounds, so the trajectory and its eval are marked ``slow``; the float64
gradient identity on the leg's first batch (about 12 s) runs in the
default set.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_learning_trace as lt  # noqa: E402

ROUNDS = 3
UPDATE_RTOL, UPDATE_GROWTH = 5e-3, 4.0
STAT_TOL = (1e-3, 1e-4)


@pytest.fixture(scope="module")
def mid(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = str(tmp_path_factory.mktemp("learn_data"))
        os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "64")
        pair = lt.Pair("mid_uncompressed", data)
        recs = []
        for i, batch in enumerate(pair.train_loader):
            if i == ROUNDS:
                break
            rec = pair.round(batch)
            js, ts = pair.ref.stats(), pair.other.stats()
            rec["stats_wide"] = max(lt.tol_ratio(ts[k], js[k], *STAT_TOL)
                                    for k in js)
            recs.append(rec)
        return pair.flat0.size, recs, pair.evaluate()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.slow
def test_rounds_track_jax(mid):
    d, recs, _ = mid
    assert d == 927_000
    for i, rec in enumerate(recs):
        assert rec["loss"] <= 1.0, (i, rec)         # rtol=1e-4
        assert rec["other_acc"] == rec["jax_acc"], (i, rec)
        assert rec["update_rel_l2"] <= UPDATE_RTOL * UPDATE_GROWTH ** i, \
            (i, rec)
        assert rec["stats_wide"] <= 1.0, (i, rec)
        assert rec["kept"] > 0.999, (i, rec)        # dense: all move


@pytest.mark.slow
def test_eval_after_the_rounds_tracks_jax(mid):
    _, _, ev = mid
    np.testing.assert_allclose(ev["other_test_loss"], ev["jax_test_loss"],
                               rtol=1e-4)
    assert ev["other_test_acc"] == ev["jax_test_acc"]


def test_first_round_gradient_is_the_jax_math(tmp_path):
    """The round's first client gradient at these widths, on the leg's
    first batch, from JAX's initial weights and statistics: the port's
    float64 gradient equals the JAX package's float64 one (the same
    function), and the port's float32 one is within 1e-4 of it."""
    os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "64")
    res = lt.grad_check("mid_uncompressed", str(tmp_path), n_clients=1,
                        jax32=False)
    assert res["d"] == 927_000 and res["clients"] == 1
    assert res["port64"]["rel_l2"] < 1e-6, res
    assert res["port32"]["rel_l2"] < 1e-4, res


def test_spread_argv_changes_only_the_seed():
    """``learning_midscale --seeds`` runs a leg's own recipe at another
    seed: the argv differs in ``--seed`` alone."""
    from commefficient_torch.scripts import learning_midscale as lm

    for leg, spec in lm.LEGS.items():
        own = lm.leg_argv(leg, "/data")
        other = lm.leg_argv(leg, "/data", seed=spec[4] + 7)
        i = own.index("--seed") + 1
        assert own[i] == str(spec[4]) and other[i] == str(spec[4] + 7)
        assert own[:i] + own[i + 1:] == other[:i] + other[i + 1:]
        assert lm.leg_argv(leg, "/data", seed=None) == own
