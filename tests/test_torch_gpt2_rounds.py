"""The port's GPT-2 round against the JAX package on the CPU: the server
step fed one gradient, 3-round sketch / virtual and ``uncompressed``
trajectories through ``FedModel`` / ``FedOptimizer``, the streaming
client phase's plan at full width, the round's own dropout, and
``python -m commefficient_torch.gpt2_train`` on the CPU.

The model is a tiny GPT-2 (n_embd 64, 2 layers, 2 heads, vocab 512, 32
tokens) with dropout 0 wherever JAX is compared (the two frameworks draw
different dropout masks).

Tolerances: the sketch table of one gradient, the top-k threshold and
the kept set are exact. In a trajectory the client gradients are summed
in another order than XLA's and the forward rounds differently in the
last bits (``tests/test_torch_gpt2.py``), so per-client losses agree to
``rtol=1e-4``, weights to ``rtol=1e-4, atol=1e-6`` after each round, the
kept sets overlap by at least 0.99 per round (coordinates at the top-k cut
may swap), and the val NLL after 3 rounds to ``rtol=1e-4``.
"""

import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated.checkpoint import (  # noqa: E402
    load_checkpoint as j_load_checkpoint,
)
from commefficient_tpu.federated.losses import (  # noqa: E402
    make_gpt2_losses as j_losses,
)
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JGPT2  # noqa: E402
from commefficient_tpu.ops import flat as jflat  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch import gpt2_train  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer  # noqa: E402
from commefficient_torch.federated.checkpoint import (  # noqa: E402
    load_checkpoint as t_load_checkpoint,
)
from commefficient_torch.federated.losses import (  # noqa: E402
    make_gpt2_losses as t_losses,
)
from commefficient_torch.models.gpt2 import GPT2DoubleHeads  # noqa: E402
from commefficient_torch.ops import flat as tflat  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

TINY = dict(vocab_size=512, n_positions=64, n_embd=64, n_layer=2, n_head=2)
W, B, C, T, NCLIENTS = 3, 2, 2, 32, 6
SKETCH = ["--mode", "sketch", "--error_type", "virtual",
          "--local_momentum", "0", "--virtual_momentum", "0.9",
          "--k", "2000", "--num_cols", "20000", "--num_rows", "5",
          "--num_blocks", "20"]
UNCOMPRESSED = ["--mode", "uncompressed", "--error_type", "none",
                "--local_momentum", "0", "--virtual_momentum", "0.9"]
COMMON = ["--num_workers", str(W), "--num_devices", "1",
          "--num_clients", str(NCLIENTS), "--dataset_name", "PERSONA",
          "--local_batch_size", str(B), "--max_seq_len", str(T),
          "--seed", "0", "--no_telemetry"]
LR = 0.05


def _jax_params():
    jm = JGPT2(**TINY, dropout=0.0)
    ids = jnp.zeros((1, C, T), jnp.int32)
    params = jm.init(jax.random.key(0), ids, token_type_ids=ids,
                     mc_token_ids=jnp.zeros((1, C), jnp.int32),
                     train=False)["params"]
    return jm, params


def _batch(rnd, vocab=TINY["vocab_size"]):
    rng = np.random.RandomState(50 + rnd)
    lm = rng.randint(0, vocab, (W, B, C, T)).astype(np.int64)
    lm[..., :T // 3] = -1
    mask = np.ones((W, B), np.float32)
    wmask = np.ones(W, np.float32)
    if rnd == 1:  # a short client and a padded slot
        mask[1, 1] = 0.0
        mask[2] = 0.0
        wmask[2] = 0.0
    return {
        "input_ids": rng.randint(0, vocab, (W, B, C, T)).astype(np.int64),
        "token_type_ids": rng.randint(0, vocab, (W, B, C, T)).astype(
            np.int64),
        "lm_labels": lm,
        "mc_token_ids": rng.randint(0, T, (W, B, C)).astype(np.int64),
        "mc_labels": rng.randint(0, C, (W, B)).astype(np.int64),
        "mask": mask,
        "client_ids": rng.choice(NCLIENTS, W, replace=False).astype(
            np.int32),
        "worker_mask": wmask}


def _val_batch():
    b = _batch(9)
    out = {k: v[0] for k, v in b.items()
           if k not in ("client_ids", "worker_mask", "mask")}
    out["mask"] = np.ones(B, np.float32)
    return out


def _trajectories(mode_argv):
    argv = mode_argv + COMMON
    jargs = j_parse(default_lr=4e-2, argv=argv)
    jm, params = _jax_params()
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, num_clients=NCLIENTS,
                    init_params=params)
    assert jfm.mesh is None or jfm.mesh.devices.size == 1
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    flat0 = np.asarray(ravel_pytree(params)[0])

    targs = t_parse(default_lr=4e-2, argv=argv + ["--device", "cpu"])
    tm = GPT2DoubleHeads(**TINY, dropout=0.0)
    layout = tflat.ParamLayout(tm)
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=NCLIENTS,
                   init_params=flat_from_jax(flat0, layout), device="cpu")
    topt = FedOptimizer(tfm, targs)
    topt.set_lr_factor(LR)

    out = []
    for rnd in range(3):
        b = _batch(rnd)
        jres = jfm(b)
        jopt.step()
        tres = tfm(b)
        topt.step()
        jw = np.asarray(ravel_pytree(jfm.params)[0])
        tw = layout.flatten(tfm.params).numpy()
        out.append((jres, tres, jw, tw))
    jfm.train(False)
    tfm.train(False)
    vb = _val_batch()
    return flat0, out, jfm(vb), tfm(vb)


@pytest.mark.parametrize("mode", ["sketch", "uncompressed"])
def test_three_round_trajectory(mode):
    flat0, out, jval, tval = _trajectories(
        SKETCH if mode == "sketch" else UNCOMPRESSED)
    jprev = tprev = flat0
    for jres, tres, jw, tw in out:
        # no train metrics: [loss, download, upload]
        assert len(tres) == len(jres) == 3
        np.testing.assert_allclose(tres[0], jres[0], rtol=1e-4)
        np.testing.assert_array_equal(tres[2], jres[2])
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
        if mode == "sketch":
            jsel = set(np.flatnonzero(jw != jprev))
            tsel = set(np.flatnonzero(tw != tprev))
            assert len(jsel & tsel) >= 0.99 * max(len(jsel), len(tsel))
        jprev, tprev = jw, tw
    assert len(tval) == len(jval) == 2  # (nll, accuracy)
    np.testing.assert_allclose(tval[0], jval[0], rtol=1e-4)
    np.testing.assert_array_equal(tval[1], jval[1])


def test_server_step_on_one_gradient_exact():
    """One GPT-2 gradient (the JAX loss's, flat) sketched by both: the
    table, the query, the top-k threshold and the kept set bit-equal."""
    jm, params = _jax_params()
    jtrain, _ = j_losses(jm)
    b = {k: jnp.asarray(v[0]) for k, v in _batch(0).items()
         if k not in ("client_ids", "worker_mask")}
    g = jax.grad(lambda p: jtrain(p, {}, b, jax.random.key(0), True)[0])(
        params)
    flat = np.asarray(ravel_pytree(g)[0])
    d, k = flat.size, 2000
    js = jsk.make_sketch(d, 20000, 5, seed=0, num_blocks=20)
    ts = tsk.make_sketch(d, 20000, 5, seed=0, num_blocks=20, device="cpu")
    jtab = np.asarray(jsk.sketch_chunks(
        js, js.chunk_layout.chunk(jnp.asarray(flat))))
    ttab = tsk.sketch_chunks(ts, ts.chunk_layout.chunk(
        torch.from_numpy(flat.copy())))
    np.testing.assert_array_equal(ttab.numpy(), jtab)
    jest = np.asarray(jsk.estimates_chunks(js, jnp.asarray(jtab)))
    test_ = tsk.estimates_chunks(ts, ttab)
    np.testing.assert_array_equal(test_.numpy(), jest)
    assert int(ttk.resolve_threshold(test_, k)) == \
        int(jtk.resolve_threshold(jnp.asarray(jest), k))
    jupd = np.asarray(jsk.unsketch_chunks(js, jnp.asarray(jtab), k))
    tupd = tsk.unsketch_chunks(ts, ttab, k).numpy()
    np.testing.assert_array_equal(tupd, jupd)
    assert (tupd != 0).sum() >= k


def test_stream_plan_at_full_width():
    """GPT-2's 150 leaves at d = 124,444,417 (no weights allocated): the
    port's leaf segments and coalescing plan equal the JAX package's, and
    ``wte`` (38,601,216 floats, over the budget by itself) forms its own
    group."""
    with torch.device("meta"):
        tm = GPT2DoubleHeads(vocab_size=50_262)
    layout = tflat.ParamLayout(tm)
    assert layout.d == 124_444_417
    tsegs = tflat.leaf_segments(layout)
    jm = JGPT2(vocab_size=50_262)
    ids = jnp.zeros((1, 2, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), ids, token_type_ids=ids,
        mc_token_ids=jnp.zeros((1, 2), jnp.int32), train=False))["params"]
    jsegs = jflat.leaf_segments(shapes)
    assert len(tsegs) == len(jsegs) == 150
    assert [tuple(s) for s in tsegs] == [tuple(s) for s in jsegs]
    ts = tsk.make_sketch(layout.d, 500_000, 5, seed=0, num_blocks=20,
                         device="cpu")
    js = jsk.make_sketch(layout.d, 500_000, 5, seed=0, num_blocks=20)
    budget = tsk.coalesce_vmem_budget(ts)
    assert budget == jsk.coalesce_vmem_budget(js) == 32 << 20
    tgroups = tflat.coalesce_segments(tsegs, budget, chunk_elems=ts.c_pad)
    jgroups = jflat.coalesce_segments(jsegs, budget, chunk_elems=js.c_pad)
    assert [tuple(g) for g in tgroups] == [tuple(g) for g in jgroups]
    wte = next(g for g in tgroups if tsegs[g.start].path == "wte/embedding")
    assert (wte.stop - wte.start, wte.size) == (1, 38_601_216)
    assert (wte.t_b - wte.t_a) * ts.c_pad * 4 > budget


def _dropout_fm(seed, W_=2):
    argv = SKETCH + ["--num_workers", str(W_), "--num_clients", "4",
                     "--dataset_name", "PERSONA", "--local_batch_size",
                     str(B), "--seed", str(seed), "--device", "cpu"]
    args = t_parse(default_lr=4e-2, argv=argv)
    tm = GPT2DoubleHeads(**TINY, dropout=0.1)
    train, val = t_losses(tm)
    fm = FedModel(tm, train, args, val, num_clients=4, device="cpu")
    opt = FedOptimizer(fm, args)
    opt.set_lr_factor(LR)
    return fm, opt


def _same_data_batch(W_=2):
    b = _batch(0)
    out = {}
    for k, v in b.items():
        if k == "client_ids":
            out[k] = np.arange(W_, dtype=np.int32)
        elif k == "worker_mask":
            out[k] = np.ones(W_, np.float32)
        else:
            out[k] = np.repeat(v[:1], W_, axis=0)
    return out


def test_round_dropout_from_the_seed():
    """The fused round draws each client's dropout masks from the round's
    generator: two models seeded alike give the same losses and weights,
    clients with the same data get different masks, and another seed
    gives other masks."""
    runs = []
    for seed in (3, 3, 4):
        fm, opt = _dropout_fm(seed)
        res = []
        for _ in range(2):
            res.append(fm(_same_data_batch())[0])
            opt.step()
        runs.append((res, fm.layout.unchunk(fm.ps_weights).clone()))
    (a, wa), (b, wb), (c, _) = runs
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(wa, wb)
    assert a[0][0] != a[0][1]  # one batch, two clients, two masks
    assert not np.array_equal(a[0], c[0])


def test_stream_round_with_dropout_runs():
    """The streaming client phase (--stream_sketch --sketch_coalesce)
    draws the same masks as the composed one from one seed; with one
    microbatch and no weight decay their tables are equal."""
    extra = ["--weight_decay", "0"]
    tables = []
    for stream in ([], ["--stream_sketch", "--sketch_coalesce"]):
        argv = SKETCH + extra + stream + [
            "--num_workers", "2", "--num_clients", "4", "--dataset_name",
            "PERSONA", "--local_batch_size", str(B), "--seed", "1",
            "--device", "cpu"]
        args = t_parse(default_lr=4e-2, argv=argv)
        tm = GPT2DoubleHeads(**TINY, dropout=0.1)
        train, val = t_losses(tm)
        fm = FedModel(tm, train, args, val, num_clients=4, device="cpu")
        assert (fm.steps.stream_groups is not None) == bool(stream)
        fm.begin_round(_same_data_batch())
        tables.append(fm._round_ctx.gradient)
    assert torch.equal(tables[0], tables[1])


TRAIN_ARGV = ["--device", "cpu", "--num_epochs", "1", "--num_workers", "2",
              "--local_batch_size", "2", "--max_seq_len", "32",
              "--mode", "sketch", "--error_type", "virtual",
              "--local_momentum", "0", "--virtual_momentum", "0.9",
              "--k", "5000", "--num_cols", "20000", "--num_rows", "3",
              "--num_blocks", "2", "--seed", "0"]


def test_gpt2_train_cpu_epoch_saves_for_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
    monkeypatch.setenv("COMMEFFICIENT_RUN_DIR", str(tmp_path / "run"))
    stats = gpt2_train.train(TRAIN_ARGV + ["--dataset_dir",
                                           str(tmp_path / "data"),
                                           "--eval_before_start"])
    assert np.isfinite(stats["val_nll"]) and np.isfinite(stats["val_ppl"])
    assert stats["val_ppl"] == pytest.approx(np.exp(stats["val_nll"]))
    path = str(tmp_path / "run" / "model")
    jparams, jstate = j_load_checkpoint(path)
    tparams, _ = t_load_checkpoint(path)
    assert jstate == {}
    # the tree of the JAX package's own tiny model (vocab max(512, 262),
    # 32 positions), leaf for leaf
    jm = JGPT2(vocab_size=512, n_positions=32, n_embd=64, n_layer=2,
               n_head=2)
    ids = jnp.zeros((1, 2, 32), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), ids, token_type_ids=ids,
        mc_token_ids=jnp.zeros((1, 2), jnp.int32), train=False))["params"]
    jflat_leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [(str(p), np.shape(x)) for p, x in jflat_leaves] == \
        [(str(p), tuple(s.shape)) for p, s in want]
    for (p, a), (_, b) in zip(jflat_leaves,
                              jax.tree_util.tree_flatten_with_path(
                                  tparams)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    # the tokenizer the run saved reads back in the JAX package
    from commefficient_tpu.data_utils.tokenization import get_tokenizer

    assert len(get_tokenizer(str(tmp_path / "run"))) == 262


def test_gpt2_train_refuses_what_is_not_ported(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            gpt2_train.train(TRAIN_ARGV[2:])
    # the 2-D plane's flags are ported, with the JAX package's checks
    with pytest.raises(AssertionError, match="requires --server_shard"):
        gpt2_train.train(TRAIN_ARGV + ["--shard_devices", "2"])
    with pytest.raises(AssertionError, match="require --server_shard"):
        gpt2_train.train(TRAIN_ARGV + ["--collective_plan",
                                       "table=ici:fp32/dcn:int8"])
    # so are the pipeline's, with the JAX package's checks
    with pytest.raises(AssertionError,
                       match="--pipeline_devices must be >= 1"):
        gpt2_train.train(TRAIN_ARGV + ["--pipeline_devices", "0"])
    with pytest.raises(AssertionError, match="--pp_microbatches must be >= 1"):
        gpt2_train.train(TRAIN_ARGV + ["--pp_microbatches", "0"])
    assert os.environ.get("COMMEFFICIENT_RUN_DIR") is None
