"""The public names the port carries beside its modules, each against the
JAX package's: the schedules and loggers of ``utils`` (``Exp``, ``Const``,
``Logger``, ``TSVLogger``), ``FedModel.state_dict``,
``ResNet9.finetune_trainable`` and the reference's ragged
``personachat_collate_fn``. (``topk(..., method="sort")`` is held in
``tests/test_torch_topk.py``.) Everything is compared exactly.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu import utils as jutils  # noqa: E402
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.data_utils.fed_persona import (  # noqa: E402
    personachat_collate_fn as j_ragged,
)
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_cv  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_torch import utils as tutils  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.data_utils.fed_persona import (  # noqa: E402
    personachat_collate_fn as t_ragged,
)
from commefficient_torch.federated import FedModel  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))


@pytest.mark.parametrize("t", [0, 1, 2.5, 7, 30])
def test_schedules_match_jax(t):
    assert tutils.Exp(0.4, 0.93)(t) == jutils.Exp(0.4, 0.93)(t)
    assert tutils.Const(0.25)(t) == jutils.Const(0.25)(t)
    assert tutils.Exp(2.0, 0.5) == tutils.Exp(2.0, 0.5)


def test_loggers_match_jax():
    """``Logger`` prints what the JAX package's prints, verbose or not;
    ``TSVLogger`` renders the same table."""
    for verbose in (True, False):
        outs = []
        for mod in (jutils, tutils):
            buf = io.StringIO()
            with redirect_stdout(buf):
                lg = mod.Logger(verbose)
                lg.debug("round", 3, sep="|")
                lg.info("done")
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
        assert (outs[1] != "") == verbose
    rows = [{"epoch": 1, "total_time": 4321.5, "test_acc": 0.5},
            {"epoch": 2, "total_time": 9000.0}, {"test_acc": 0.75}]
    j, t = jutils.TSVLogger(), tutils.TSVLogger()
    for row in rows:
        j.append(row)
        t.append(row)
    assert str(t) == str(j)
    assert t.log == j.log


def test_finetune_trainable_matches_jax():
    """Every flax path of ResNet9 (the head with a new class count
    included): the port's head-only mask equals the JAX package's."""
    m = ResNet9(channels=TINY, new_num_classes=62)
    paths = [e.jax_path for e in ParamLayout(m).entries]
    assert ("linear", "kernel") in paths
    got = [ResNet9.finetune_trainable(p) for p in paths]
    assert got == [JResNet9.finetune_trainable(p) for p in paths]
    assert sum(got) == 1


def test_state_dict_matches_jax():
    """``FedModel.state_dict`` from the same initial weights: the JAX
    package's tree of numpy arrays, leaf for leaf, bit for bit."""
    argv = ["--mode", "uncompressed", "--error_type", "none",
            "--local_momentum", "0", "--num_workers", "2", "--num_devices",
            "1", "--num_clients", "4", "--dataset_name", "CIFAR10",
            "--local_batch_size", "2", "--seed", "0", "--no_telemetry"]
    jm = JResNet9(channels=TINY)
    jtrain, jval = j_cv(jm)
    jfm = JFedModel(jm, jtrain, j_parse(argv=argv), jval,
                    input_shape=(32, 32, 3), num_clients=4)
    want = jfm.state_dict()
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])
    tm = ResNet9(channels=TINY)
    ttrain, tval = make_cv_losses(tm)
    tfm = FedModel(tm, ttrain, t_parse(argv=argv + ["--device", "cpu"]),
                   tval, num_clients=4,
                   init_params=flat_from_jax(flat0, ParamLayout(tm)),
                   device="cpu")
    got = tfm.state_dict()
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [str(p) for p, _ in tl] == [str(p) for p, _ in jl]
    for (p, a), (_, b) in zip(tl, jl):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_ragged_collate_matches_jax():
    """The reference's ragged collate: the client ids, the padded inputs
    at the batch's longest sequence and the stacked rest, equal to the
    JAX package's."""
    rng = np.random.RandomState(11)
    records = []
    for cid in range(3):
        lens = rng.randint(3, 20, 2)
        records.append((cid,
                        [list(rng.randint(0, 99, L)) for L in lens],
                        [L - 1 for L in lens],
                        [list(np.where(rng.rand(L) < 0.5, -1,
                                       rng.randint(0, 99, L))) for L in lens],
                        int(rng.randint(0, 2)),
                        [list(rng.randint(0, 99, L)) for L in lens]))
    want, got = j_ragged(records), t_ragged(records)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    assert got[1].shape == (3, 2, max(len(s) for r in records
                                      for s in r[1]))
    assert (got[3] == -1).any()
