"""The port's download-byte accounting (``FedModel._account_bytes_deferred``,
regime (b): ``num_epochs > 1`` or a finite local batch) against the JAX
package's device-resident form (``_mark_changed`` /
``_changed_since_counts`` of ``commefficient_tpu/federated/aggregator.py``)
on the CPU, at a tail-heavy chunk geometry.

With ``d`` just over one chunk, the padded tail of the ``(T, S, 128)``
layout is almost a whole chunk. Its ``last_changed`` entries stay at the
``-1`` sentinel (the tail is zero in every snapshot), so they are never
counted against a participant. Counts are integers: they must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.federated import aggregator as jagg  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.federated import FedModel  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402
from tests.test_torch_rounds import ARGV, NCLIENTS, TINY  # noqa: E402

ROUNDS = 9


def _tail_heavy_model():
    """A FedModel in accounting regime (b) whose sketch width puts d just
    over one chunk."""
    model = ResNet9(channels=TINY)
    d = ParamLayout(model).d
    c_pad = (d - 1) // 128 * 128
    argv = [a for a in ARGV]
    argv[argv.index("--num_cols") + 1] = str(c_pad)
    args = t_parse(argv=argv + ["--num_epochs", "3", "--device", "cpu"])
    train, _ = make_cv_losses(model)
    fm = FedModel(model, train, args, num_clients=NCLIENTS, device="cpu")
    assert not fm._simple_download
    assert fm.sketch.T == 2 and fm.sketch.c_pad == c_pad
    return fm


def _snapshots(d, seed):
    """Flat weights a round: a random set of coordinates moves each round,
    every coordinate in round 4, none in round 6."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d).astype(np.float32)
    out = [w.copy()]
    for rnd in range(ROUNDS):
        if rnd == 4:
            w = w + np.float32(1.0)
        elif rnd != 6:
            idx = rng.choice(d, size=rng.randint(1, d // 10), replace=False)
            w[idx] += rng.randn(idx.size).astype(np.float32)
        out.append(w.copy())
    return out


PATTERNS = {
    "all-every-round": lambda rng, rnd: np.arange(NCLIENTS),
    "random-cohorts": lambda rng, rnd: np.sort(
        rng.choice(NCLIENTS, 3, replace=False)),
    "rare-and-frequent": lambda rng, rnd: np.array(
        [0] + ([5] if rnd % 4 == 3 else [])),
    "some-rounds-empty": lambda rng, rnd: (
        np.array([], np.int64) if rnd % 3 == 1 else np.array([rnd % NCLIENTS])),
}


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_download_counts_equal_jax_at_tail_heavy_geometry(pattern):
    fm = _tail_heavy_model()
    layout = fm.layout
    d = fm.grad_size
    assert layout.shape[0] * layout.shape[1] * layout.shape[2] - d > \
        fm.sketch.c_pad - 300   # the padded tail is almost a chunk
    snaps = _snapshots(d, seed=len(pattern))
    rng = np.random.RandomState(3)

    fm.ps_weights = layout.chunk(torch.from_numpy(snaps[0]))
    fm._prev_ps = fm.ps_weights
    j_last = jnp.full(layout.shape, -1, jnp.int32)
    j_prev = jnp.asarray(fm.ps_weights.numpy())
    j_round, j_part = 0, np.zeros(NCLIENTS, np.int64)
    for rnd in range(ROUNDS):
        participating = PATTERNS[pattern](rng, rnd)
        # the server update of round rnd lands before the next accounting
        fm.ps_weights = layout.chunk(torch.from_numpy(snaps[rnd + 1]))
        got, upload = fm._account_bytes_deferred(participating)

        cur = jnp.asarray(fm.ps_weights.numpy())
        j_last = jagg._mark_changed(j_last, cur, j_prev, j_round)
        j_prev = cur
        j_round += 1
        if len(participating):
            want = np.asarray(jagg._changed_since_counts(
                j_last, jnp.asarray(j_part[participating], jnp.int32)))
            np.testing.assert_array_equal(got.numpy(), want)
            assert want.max() <= d
            if rnd == 4:   # every coordinate moved: exactly d, no tail
                assert want.max() == d
        else:
            assert got is None
        j_part[participating] = j_round
        assert upload[participating].tolist() == \
            [4 * fm.sketch.r * fm.sketch.c_pad] * len(participating)
    np.testing.assert_array_equal(fm._last_changed.numpy(),
                                  np.asarray(j_last))
    tail = fm._last_changed.reshape(-1)[d:]
    assert tail.numel() > 0 and bool((tail == -1).all())
