"""The port's pipeline for GPT-2 (``parallel/pipeline.py``, the grid's
``stage`` axis, the round's sum over it) against the JAX package's
``make_gpt2_pp_losses`` and rounds on its CPU mesh, mirroring
``tests/test_pipeline.py`` (``TestLayerRanges``, ``TestPPLosses``,
``TestPPRound``, ``TestPPxTP``, ``TestPPxSP``, ``TestPPxEP``) at its sizes
(V 128, T 16, C 32, L 3, H 4; the MoE model L 4 with 2 experts).

Pure functions: ``pp_layer_ranges`` and ``_auto_micro`` against JAX's,
the grid policy with a stage axis against ``default_client_mesh`` (sizes,
clamp warnings word for word, each device's process rank against JAX's
row-major device order), the MoE pattern assertion, the flags, the
one-process degrade of ``gpt2_train`` and ``cv_train``'s refusal.

On 2, 3 and 4 ``gloo`` ranks (``tests/torch_dist_ranks.py``, one spawn;
the JAX side runs in the parent meanwhile):

- the train loss, the count and the gradient summed over ``stage`` for
  ``(S, n_micro)`` in (2, 2), (3, 2), (2, 1), (2, 4), the val metrics at
  an odd batch of 5, and ``--bf16``, against JAX's pipelined loss under
  ``shard_map``: ``rtol=1e-5`` on losses, ``atol=rtol=2e-5`` on the
  gradient (JAX's own tolerances), bf16 within ``rtol=0.05`` of f32 (its
  tolerance there);
- stage x seq under ring attention and stage x expert on the MoE model
  (aux at ``coef=0.01``, one microbatch): the same against JAX's on the
  same meshes;
- two uncompressed rounds on (clients 2) x (stage 2), through the fused
  client phase and the per-client path (``--max_grad_norm``), and on
  (clients 1) x (model 2) x (stage 2), against JAX's ``FedModel`` on the
  same meshes: weights, losses and val metrics within ``2e-5``, every
  rank bit-equal;
- the dropout scheme: at dropout 0.1 the (clients 1) x (stage 2) round,
  fused and per-client, equals the port's one-rank dense round within
  ``2e-5`` (the same keep masks);
- ``gpt2_train --pipeline_devices 2`` on 2 ranks (finite val NLL, the
  ranks alike), and its ``n_layer >= n_stages`` check on 2 ranks of a
  1-layer model.
"""

import functools
import io
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from commefficient_tpu.compat import shard_map  # noqa: E402
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JGPT2  # noqa: E402
from commefficient_tpu.parallel import mesh as JM  # noqa: E402
from commefficient_tpu.parallel import make_mesh  # noqa: E402
from commefficient_tpu.parallel import pipeline as JP  # noqa: E402
from commefficient_tpu.parallel.moe import (  # noqa: E402
    ep_sliced_param as j_ep_sliced,
)
from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.federated.aggregator import (  # noqa: E402
    worker_config_from_args,
)
from commefficient_torch.models.gpt2 import GPT2DoubleHeads  # noqa: E402
from commefficient_torch.parallel import ClientGroup  # noqa: E402
from commefficient_torch.parallel import mesh as TM  # noqa: E402
from commefficient_torch.parallel import pipeline as TP  # noqa: E402
from tests.torch_dist_ranks import start_ranks  # noqa: E402

V, T, E, L, H = 128, 16, 32, 3, 4
DIMS = dict(vocab_size=V, n_positions=T, n_embd=E, n_layer=L, n_head=H)
# TestPPxEP's MoE model: 4 layers, so both stages run the same pattern
MOE = dict(n_layer=4, n_experts=2)
W, B, C, NCLIENTS, LR = 2, 2, 2, 8, 0.1
UNC = ["--mode", "uncompressed", "--error_type", "virtual",
       "--local_momentum", "0", "--virtual_momentum", "0.9"]
# the per-client path: a dense clip leaves no fused client phase
PER_CLIENT = UNC + ["--max_grad_norm", "1000"]
PP = ["--pipeline_devices", "2", "--pp_microbatches", "2"]
# the JAX meshes of the round cases: (argv, mesh axes, JAX model kw)
JAX_GRIDS = {
    "fused": (UNC + PP + ["--num_devices", "2"],
              [("clients", 2), ("stage", 2)], {}),
    "per-client": (PER_CLIENT + PP + ["--num_devices", "2"],
                   [("clients", 2), ("stage", 2)], {}),
    "stage x model": (UNC + PP + ["--num_devices", "1", "--model_devices",
                                  "2"],
                      [("clients", 1), ("model", 2), ("stage", 2)],
                      dict(model_axis="model")),
}
# the loss cases: (S, n_micro) as in JAX's TestPPLosses, the odd val
# batch, bf16 and f32, then the compositions
LOSS_CASES = {
    2: [{"stage": 2, "n_micro": 2}, {"stage": 2, "n_micro": 1},
        {"stage": 2, "n_micro": 4},
        {"stage": 2, "n_micro": 4, "val": True, "batch": "odd"},
        {"stage": 2, "n_micro": 2, "bf16": True}],
    3: [{"stage": 3, "n_micro": 2}],
    4: [{"stage": 2, "n_micro": 2, "seq": 2, "impl": "ring"},
        {"stage": 2, "n_micro": 1, "expert": 2, "coef": 0.01,
         "model": MOE, "flat": "flat_moe"}],
}


def _common():
    return ["--num_workers", str(W), "--num_clients", str(NCLIENTS),
            "--dataset_name", "PERSONA", "--local_batch_size", str(B),
            "--max_seq_len", str(T), "--seed", "0", "--no_telemetry"]


def _one_batch(seed, n):
    """One client's batch of ``n`` examples x 2 candidates, with the
    pre-shifted labels the seq-parallel loss reads."""
    rng = np.random.RandomState(seed)
    lm = rng.randint(-1, V, (n, C, T)).astype(np.int64)
    shifted = np.full_like(lm, -1)
    shifted[..., :-1] = lm[..., 1:]
    return {"input_ids": rng.randint(0, V, (n, C, T)),
            "token_type_ids": rng.randint(0, V, (n, C, T)),
            "lm_labels": lm, "lm_labels_shifted": shifted,
            "mc_token_ids": rng.randint(0, T, (n, C)),
            "mc_labels": rng.randint(0, C, (n,)),
            "mask": np.ones(n, np.float32)}


def _batch(rnd):
    rng = np.random.RandomState(80 + rnd)
    lm = rng.randint(0, V, (W, B, C, T)).astype(np.int64)
    lm[..., :T // 3] = -1
    shifted = np.full_like(lm, -1)
    shifted[..., :-1] = lm[..., 1:]
    mask = np.ones((W, B), np.float32)
    if rnd == 1:
        mask[0, 1] = 0.0  # a short client
    return {
        "input_ids": rng.randint(0, V, (W, B, C, T)),
        "token_type_ids": rng.randint(0, V, (W, B, C, T)),
        "lm_labels": lm, "lm_labels_shifted": shifted,
        "mc_token_ids": rng.randint(0, T, (W, B, C)),
        "mc_labels": rng.randint(0, C, (W, B)), "mask": mask,
        "client_ids": rng.choice(NCLIENTS, W, replace=False).astype(
            np.int32),
        "worker_mask": np.ones(W, np.float32)}


def _val_batch():
    b = _batch(9)
    out = {k: v[0] for k, v in b.items()
           if k not in ("client_ids", "worker_mask", "mask")}
    out["mask"] = np.ones(B, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(**kw):
    jm = JGPT2(**dict(DIMS, **kw), dropout=0.0)
    ids = jnp.zeros((1, C, T), jnp.int32)
    return jm.init(jax.random.key(0), ids, token_type_ids=ids,
                   mc_token_ids=jnp.zeros((1, C), jnp.int32),
                   train=False)["params"]


def _flat(params):
    return np.asarray(ravel_pytree(params)[0])


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def _jax_losses(c, batch):
    """JAX's pipelined loss of case ``c`` under ``shard_map`` over its
    mesh: the train loss, count and gradient summed over the stage (and
    seq, expert) axes, raveled; or the val sums."""
    moe = c.get("model") == MOE
    params = _jax_params(**MOE) if moe else _jax_params()
    axes, kw = [("stage", c["stage"])], {}
    if c.get("seq"):
        axes.append(("seq", c["seq"]))
        kw["attn_impl"] = c["impl"]
    if c.get("expert"):
        axes.append(("expert", c["expert"]))
        kw["expert_axis"] = "expert"
    mesh = make_mesh(axes, devices=jax.devices()[:int(np.prod(
        [n for _, n in axes]))])
    model = JGPT2(**dict(DIMS, **c.get("model", {})), dropout=0.0, **kw)
    lt, lv = JP.make_gpt2_pp_losses(
        model, c["stage"], n_micro=c["n_micro"],
        compute_dtype=jnp.bfloat16 if c.get("bf16") else None,
        moe_aux_coef=c.get("coef", 0.0))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    seqk = ("input_ids", "token_type_ids", "lm_labels_shifted")
    bspec = {k: (P(*([None] * (v.ndim - 1)), "seq")
                 if c.get("seq") and k in seqk else P())
             for k, v in b.items()}
    run = partial(shard_map, mesh=mesh, in_specs=(P(), bspec),
                  out_specs=P(), check_vma=False)
    if c.get("val"):
        nll, (acc,), cnt, _ = jax.jit(run(
            lambda p, bb: lv(p, {}, bb, jax.random.key(2), False)))(params,
                                                                      b)
        return {"nll": float(nll), "acc": float(acc), "count": float(cnt)}

    def f(p, bb):
        loss, _, cnt, _ = lt(p, {}, bb, jax.random.key(1), True)
        g = jax.grad(lambda q: lt(q, {}, bb, jax.random.key(1),
                                  True)[0])(p)

        def rec(path, x):
            x = jax.lax.psum(x, "stage")
            if c.get("seq"):
                x = jax.lax.psum(x, "seq")
            if c.get("expert"):
                keys = "/".join(str(getattr(q, "key", q))
                                for q in path).lower()
                scale = 1.0 if j_ep_sliced(keys) else 1.0 / c["expert"]
                x = jax.lax.psum(x, "expert") * scale
            return x

        return loss, cnt, jtu.tree_map_with_path(rec, g)

    loss, cnt, g = jax.jit(run(f))(params, b)
    return {"loss": float(loss), "count": float(cnt),
            "g": np.asarray(ravel_pytree(g)[0])}


def _jax_rounds(argv, axes, model_kw, params, batches):
    """Two rounds of JAX's ``FedModel`` with its pipelined loss on the mesh
    ``axes``: per round the fetched results and the weights, then the val
    metrics."""
    jargs = j_parse(default_lr=4e-2, argv=argv + _common())
    jm = JGPT2(**DIMS, dropout=0.0, **model_kw)
    jtrain, jval = JP.make_gpt2_pp_losses(jm, 2, n_micro=2)
    mesh = make_mesh(axes, devices=jax.devices()[:int(np.prod(
        [n for _, n in axes]))])
    jfm = JFedModel(jm, jtrain, jargs, jval, num_clients=NCLIENTS,
                    init_params=params, mesh=mesh)
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    out = []
    for b in batches:
        res = jfm(b)
        jopt.step()
        out.append((res, _flat(jfm.params)))
    jfm.train(False)
    return out, jfm(_val_batch()), dict(jfm.mesh.shape)


# --------------------------------------------------------------------------
# one spawn
# --------------------------------------------------------------------------

def _run(argv, nd, **kw):
    return dict({"argv": argv + _common() + ["--num_devices", str(nd)],
                 "num_devices": nd, "seq": 1, "impl": None}, **kw)


def _rounds_spec(runs, params):
    return {"W": W, "model": DIMS, "num_clients": NCLIENTS, "lr": LR,
            "flat0": _flat(params), "batches": [_batch(r) for r in range(2)],
            "val": _val_batch(), "runs": runs}


def _cli(tmp, name, extra, env=None, raises=False):
    return ("cli_gpt2_train", {
        "argv": ["--device", "cpu", "--num_epochs", "1", "--num_workers",
                 "2", "--local_batch_size", "2", "--max_seq_len", "32",
                 "--mode", "sketch", "--error_type", "virtual",
                 "--local_momentum", "0", "--virtual_momentum", "0.9",
                 "--k", "5000", "--num_cols", "20000", "--num_rows", "3",
                 "--num_blocks", "2", "--seed", "0", "--dataset_dir",
                 str(tmp / f"data_{name}"), "--num_devices", "1"] + extra,
        "env": dict({"COMMEFFICIENT_TINY_MODEL": "1",
                     "COMMEFFICIENT_SYNTHETIC_CLIENTS": "8",
                     "COMMEFFICIENT_RUN_DIR": str(tmp / f"run_{name}")},
                    **(env or {})),
        "raises": raises}, 2)


RUNS4 = [_run(JAX_GRIDS["fused"][0], 2), _run(JAX_GRIDS["per-client"][0], 2),
         _run(JAX_GRIDS["stage x model"][0], 1)]
# the dropout scheme: the pipelined round against the one-rank dense round
RUNS2 = []
for _argv in (UNC, PER_CLIENT):
    RUNS2 += [_run(_argv + PP, 1, dropout=0.1),
              _run(_argv, 1, dropout=0.1, single=True)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 4 ranks runs every body of this file while the parent
    computes JAX's side."""
    tmp = tmp_path_factory.mktemp("pp")
    params = _jax_params()
    losses = {"model": dict(DIMS, dropout=0.0), "flat0": _flat(params),
              "flat_moe": _flat(_jax_params(**MOE)),
              "batch": _one_batch(7, 4), "odd": _one_batch(8, 5)}
    batches = [_batch(r) for r in range(2)]
    items = [("body_pp_losses", dict(losses, cases=LOSS_CASES[k]), k)
             for k in (2, 3, 4)]
    items += [("body_seq_rounds", _rounds_spec(RUNS4, params), 4),
              ("body_seq_rounds", _rounds_spec(RUNS2, params), 2),
              _cli(tmp, "pp", PP),
              _cli(tmp, "deep", PP, {"COMMEFFICIENT_TINY_LAYERS": "1"},
                   raises=True)]
    with start_ranks(4, items, tmp) as ranks, ThreadPoolExecutor(4) as pool:
        jrounds = {key: pool.submit(_jax_rounds, argv, axes, kw, params,
                                    batches)
                   for key, (argv, axes, kw) in JAX_GRIDS.items()}
        jloss = {k: [pool.submit(_jax_losses, c, losses[c.get("batch",
                                                             "batch")])
                     for c in cases] for k, cases in LOSS_CASES.items()}
        # the bf16 case's f32 twin, in JAX
        jf32 = pool.submit(_jax_losses, {"stage": 2, "n_micro": 2},
                           losses["batch"])
        out = {"jrounds": {k: f.result() for k, f in jrounds.items()},
               "jloss": {k: [f.result() for f in v]
                         for k, v in jloss.items()},
               "jf32": jf32.result(), "params": params}
        outs = ranks.join()
    out.update(loss={2: outs[0], 3: outs[1], 4: outs[2]}, rounds4=outs[3],
               rounds2=outs[4], cli=outs[5], deep=outs[6])
    return out


# --------------------------------------------------------------------------
# pure functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_layer,n_stages", [(12, 4), (3, 2), (5, 3),
                                              (12, 2), (4, 4), (7, 1)])
def test_layer_ranges_match_jax(n_layer, n_stages):
    """Balanced contiguous ranges, the first ``n_layer % n_stages``
    stages one layer longer: JAX's, range for range."""
    got = TP.pp_layer_ranges(n_layer, n_stages)
    assert got == JP.pp_layer_ranges(n_layer, n_stages)
    assert got[0][0] == 0 and got[-1][1] == n_layer
    assert all(a[1] == b[0] for a, b in zip(got[:-1], got[1:]))


def test_layer_ranges_refuse_more_stages_than_layers():
    for mod in (TP, JP):
        with pytest.raises(AssertionError):
            mod.pp_layer_ranges(2, 3)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 12])
def test_auto_micro_matches_jax(n):
    """The largest divisor of the example count no larger than the
    microbatch count, for 1-5 microbatches."""
    for m in range(1, 6):
        assert TP._auto_micro(n, m) == JP._auto_micro(n, m)
        assert n % TP._auto_micro(n, m) == 0


@pytest.mark.parametrize(
    "num_workers,num_devices,seq,model,stage,expert,n_experts,world", [
        (4, -1, 1, 1, 2, 1, 0, 4), (2, 1, 1, 1, 2, 1, 0, 2),
        (2, -1, 1, 2, 2, 1, 0, 4), (2, 1, 2, 1, 2, 1, 0, 4),
        (2, 1, 1, 1, 2, 2, 2, 4), (4, -1, 1, 2, 2, 2, 4, 8),
        (2, -1, 1, 1, 3, 1, 0, 4), (2, -1, 1, 2, 4, 1, 0, 4),
        (2, -1, 1, 1, 2, 1, 0, 1)])
def test_grid_with_stage_is_the_jax_mesh_policy(num_workers, num_devices,
                                                seq, model, stage, expert,
                                                n_experts, world):
    """``grid_sizes`` against ``default_client_mesh`` with a stage axis
    over ``world`` devices: every axis size, the clamp warnings word for
    word, and each device's process rank against JAX's row-major device
    order (``(((p * Q + q) * M + m) * S + st) * E + e``)."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        mesh = JM.default_client_mesh(
            num_workers, num_devices, devices=jax.devices()[:world],
            seq_devices=seq, model_devices=model, pipeline_devices=stage,
            expert_devices=expert, n_experts=n_experts)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = TM.grid_sizes(num_workers, num_devices, 1, world, seq, model,
                            expert, n_experts, pipeline_devices=stage)
    shape = dict(mesh.shape)
    assert got == {a: shape.get(a, 1) for a in got}
    assert [a for a in got if got[a] > 1 or a == "clients"] == \
        list(mesh.axis_names)
    assert [str(w.message) for w in tw if str(w.message).startswith("--")] \
        == [str(w.message) for w in jw if str(w.message).startswith("--")]
    names = ("clients", "shard", "seq", "model", "stage", "expert")
    sizes = [got[a] for a in names]
    nc, nsh, ns, nm, npp, ne = sizes
    devs = mesh.devices.reshape(sizes)
    for c, s, q, m, st, e in np.ndindex(*sizes):
        i = devs[c, s, q, m, st, e].id
        assert TM.tuple_index(i, nc, nsh, ns, nm, ne, n_stage=npp) == \
            ((((s * nc + c) * ns + q) * nm + m) * npp + st) * ne + e


def test_moe_pattern_assertion_matches_jax():
    """An MoE model whose stages would run different dense/MoE patterns
    (3 layers on 2 stages) is refused naming ``moe_every``, as in JAX;
    4 layers on 2 stages is accepted."""
    fake = ClientGroup(None, 0, 2, torch.device("cpu"))
    with pytest.raises(AssertionError, match="moe_every"):
        TP.make_gpt2_pp_losses(GPT2DoubleHeads(**DIMS, n_experts=2), fake)
    with pytest.raises(AssertionError, match="moe_every"):
        JP.make_gpt2_pp_losses(JGPT2(**DIMS, n_experts=2), 2)
    TP.make_gpt2_pp_losses(GPT2DoubleHeads(**dict(DIMS, **MOE)), fake)


@pytest.mark.parametrize("argv", [["--pipeline_devices", "2"],
                                  ["--pp_microbatches", "3"],
                                  ["--pipeline_devices", "3",
                                   "--pp_microbatches", "1"]])
def test_flags_parse_as_jax(argv):
    """``--pipeline_devices`` and ``--pp_microbatches`` parse with the JAX
    package's defaults and values; below 1 they fail its checks."""
    base = ["--mode", "uncompressed", "--local_momentum", "0"]
    ja, ta = j_parse(argv=base + argv), t_parse(argv=base + argv + [
        "--device", "cpu"])
    for dest in ("pipeline_devices", "pp_microbatches"):
        assert getattr(ta, dest) == getattr(ja, dest)
    d = t_parse(argv=base + ["--device", "cpu"])
    assert (d.pipeline_devices, d.pp_microbatches) == (1, 4)
    for bad in (["--pipeline_devices", "0"], ["--pp_microbatches", "0"]):
        with pytest.raises(AssertionError, match="must be >= 1"):
            t_parse(argv=base + bad + ["--device", "cpu"])
        with pytest.raises(AssertionError, match="must be >= 1"):
            j_parse(argv=base + bad)


def test_degrades_gracefully_without_devices(tmp_path, monkeypatch):
    """``--pipeline_devices 2`` in one process: the grid policy warns as
    JAX's does, the worker takes no stage axis, and ``gpt2_train`` trains
    the dense model (its stats equal the run without the flag)."""
    with pytest.warns(UserWarning, match="--pipeline_devices 2 reduced"):
        sizes = TM.grid_sizes(2, -1, world=1, pipeline_devices=2)
    assert sizes["stage"] == 1
    args = t_parse(argv=["--device", "cpu", "--mode", "uncompressed",
                         "--local_momentum", "0", "--pipeline_devices", "2"])
    assert worker_config_from_args(args, None).pp_axis is None
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
    argv = ["--device", "cpu", "--num_epochs", "0.3", "--num_workers", "2",
            "--local_batch_size", "2", "--max_seq_len", "32", "--mode",
            "uncompressed", "--error_type", "none", "--local_momentum", "0",
            "--seed", "0", "--dataset_dir", str(tmp_path / "d"),
            "--no_telemetry"]
    stats = []
    for extra in ([], PP):
        monkeypatch.setenv("COMMEFFICIENT_RUN_DIR",
                           str(tmp_path / f"run{len(extra)}"))
        with warnings.catch_warnings(record=True) as caught, \
                redirect_stdout(io.StringIO()):
            warnings.simplefilter("always")
            stats.append(gpt2_train.train(argv + extra))
        if extra:
            assert any("--pipeline_devices 2 reduced to 1" in str(w.message)
                       for w in caught)
    keys = ("val_nll", "val_acc", "val_ppl")
    assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]


def test_cv_entrypoint_rejects_pipeline_devices(tmp_path):
    """The pipeline is GPT-2 only: ``cv_train`` raises the JAX package's
    assertion."""
    with pytest.raises(AssertionError, match="GPT-2 only"):
        cv_train.main(["--device", "cpu", "--dataset_name", "CIFAR10",
                       "--dataset_dir", str(tmp_path / "d"),
                       "--mode", "uncompressed", "--local_momentum", "0",
                       "--pipeline_devices", "2"])


# --------------------------------------------------------------------------
# across ranks
# --------------------------------------------------------------------------

def _check_loss(got, want, what):
    for r in got:
        if "nll" in want:
            np.testing.assert_allclose(r["nll"], want["nll"], rtol=1e-5,
                                       err_msg=what)
            assert r["acc"] == want["acc"] and r["count"] == want["count"]
            continue
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5,
                                   err_msg=what)
        assert r["count"] == want["count"], what
        np.testing.assert_allclose(r["g"], want["g"], atol=2e-5, rtol=2e-5,
                                   err_msg=what)
        # the gradient is made whole on every rank
        np.testing.assert_array_equal(r["g"], got[0]["g"], err_msg=what)


class TestPPLosses:
    @pytest.mark.parametrize("k,i,S,n_micro", [(2, 0, 2, 2), (3, 0, 3, 2),
                                               (2, 1, 2, 1), (2, 2, 2, 4)])
    def test_train_loss_and_grad_match_jax(self, spawned, k, i, S, n_micro):
        """The pipelined train loss, count and stage-summed gradient on
        ``S`` stages with ``n_micro`` microbatches against JAX's on its
        ``stage`` mesh."""
        assert LOSS_CASES[k][i] == {"stage": S, "n_micro": n_micro}
        got = [r[i] for r in spawned["loss"][k]]
        assert [r["process_rank"] for r in got] == list(range(S))
        _check_loss(got, spawned["jloss"][k][i], f"S={S} n_micro={n_micro}")

    def test_val_matches_jax_odd_batch(self, spawned):
        """An odd val batch of 5 at ``n_micro = 4`` degrades to one
        microbatch: the val NLL, accuracy and count against JAX's."""
        got = [r[3] for r in spawned["loss"][2]]
        _check_loss(got, spawned["jloss"][2][3], "val")

    def test_bf16_compute_tracks_f32(self, spawned):
        """``compute_dtype=bf16`` (activations and hops in bf16): the loss
        within ``rtol=0.05`` of the f32 pipeline's and of JAX's bf16
        pipeline's, finite."""
        got = [r[4] for r in spawned["loss"][2]]
        f32 = spawned["loss"][2][0][0]["loss"]
        for r in got:
            assert np.isfinite(r["loss"]) and np.isfinite(r["g"]).all()
            np.testing.assert_allclose(r["loss"], f32, rtol=0.05)
            np.testing.assert_allclose(r["loss"], spawned["jloss"][2][4][
                "loss"], rtol=0.05)
        np.testing.assert_allclose(spawned["jf32"]["loss"], f32, rtol=1e-5)


class TestPPCompositions:
    def test_stage_x_seq_ring_matches_jax(self, spawned):
        """(stage 2) x (seq 2) under ring attention: each rank's loss and
        gradient (summed over stage and seq) against JAX's on its (stage,
        seq) mesh."""
        got = [r[0] for r in spawned["loss"][4]]
        _check_loss(got, spawned["jloss"][4][0], "stage x seq")

    def test_stage_x_expert_matches_jax(self, spawned):
        """(stage 2) x (expert 2) on the MoE model with the aux at
        ``coef = 0.01`` and one microbatch: loss and gradient (summed
        over stage, then expert times ``ep_scale``) against JAX's."""
        got = [r[1] for r in spawned["loss"][4]]
        _check_loss(got, spawned["jloss"][4][1], "stage x expert")


def _check_trajectory(jout, jval, ranks, flat0, what, tol=2e-5):
    for rnd, (jres, jw) in enumerate(jout):
        for r in ranks:
            np.testing.assert_allclose(r["res"][rnd][0], jres[0], rtol=tol,
                                       atol=tol, err_msg=f"{what} {rnd}")
            np.testing.assert_array_equal(r["res"][rnd][2], jres[2])
            np.testing.assert_array_equal(
                r["w"][rnd].view(np.uint32),
                ranks[0]["w"][rnd].view(np.uint32),
                err_msg=f"{what} ranks {rnd}")
        np.testing.assert_allclose(ranks[0]["w"][rnd], jw, rtol=tol,
                                   atol=tol, err_msg=f"{what} round {rnd}")
    assert np.abs(ranks[0]["w"][-1] - flat0).max() > 0
    for r in ranks:
        np.testing.assert_allclose(r["val"][0], jval[0], rtol=tol, atol=tol)
        np.testing.assert_array_equal(r["val"][1], jval[1])


class TestPPRound:
    @pytest.mark.parametrize("i,phase", [(0, "fused"), (1, "per-client")])
    def test_round_matches_jax(self, spawned, i, phase):
        """Two uncompressed rounds on (clients 2) x (stage 2), through the
        fused client phase and the per-client path, against JAX's rounds
        on its (clients 2, stage 2) mesh: weights, losses and val metrics
        within ``2e-5``, the four ranks bit-equal."""
        ranks = [r[i] for r in spawned["rounds4"]]
        assert [(r["rank"], r["stage"]) for r in ranks] == \
            [(0, (0, 2)), (0, (1, 2)), (1, (0, 2)), (1, (1, 2))]
        assert [r["process_rank"] for r in ranks] == [0, 1, 2, 3]
        assert all(r["pp_axis"] == "stage" and r["model"] is None
                   for r in ranks)
        assert [a["name"] for a in ranks[0]["topology"]["axes"]] == \
            ["clients", "stage"]
        assert [r["is_main"] for r in ranks] == [True, False, False, False]
        jout, jval, jshape = spawned["jrounds"][phase]
        assert jshape == {"clients": 2, "stage": 2}
        _check_trajectory(jout, jval, ranks, _flat(spawned["params"]), phase)

    def test_stage_x_model_round_matches_jax(self, spawned):
        """Two rounds on (clients 1) x (model 2) x (stage 2) against JAX's
        on its (clients 1, model 2, stage 2) mesh within ``2e-5``, the
        four ranks bit-equal (JAX's ``TestPPxTP``)."""
        ranks = [r[2] for r in spawned["rounds4"]]
        assert [(r["model"], r["stage"]) for r in ranks] == \
            [((0, 2), (0, 2)), ((0, 2), (1, 2)), ((1, 2), (0, 2)),
             ((1, 2), (1, 2))]
        assert all(r["pp_axis"] == "stage" and r["model_axis"] == "model"
                   for r in ranks)
        jout, jval, jshape = spawned["jrounds"]["stage x model"]
        assert jshape == {"clients": 1, "model": 2, "stage": 2}
        _check_trajectory(jout, jval, ranks, _flat(spawned["params"]),
                          "stage x model")

    @pytest.mark.parametrize("i,phase", [(0, "fused"), (2, "per-client")])
    def test_dropout_round_equals_the_dense_round(self, spawned, i, phase):
        """At dropout 0.1 the (clients 1) x (stage 2) round reads the keep
        masks the dense round draws (the fused phase's pre-drawn masks,
        the per-client path's generator in the dense forward's order):
        both rounds' weights and losses within ``2e-5`` of the port's
        one-rank dense round, the stage ranks bit-equal."""
        pp = [r[i] for r in spawned["rounds2"]]
        dense = spawned["rounds2"][0][i + 1]
        assert pp[0]["pp_axis"] == "stage" and dense["pp_axis"] is None
        if phase == "fused":
            for a, b in zip(pp[0]["draws"], dense["draws"]):
                np.testing.assert_array_equal(a, b)
                assert 0.85 < a.mean() < 0.95
        for rnd in range(2):
            np.testing.assert_array_equal(pp[0]["w"][rnd].view(np.uint32),
                                          pp[1]["w"][rnd].view(np.uint32))
            np.testing.assert_allclose(pp[0]["w"][rnd], dense["w"][rnd],
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=f"{phase} round {rnd}")
            np.testing.assert_allclose(pp[0]["res"][rnd][0],
                                       dense["res"][rnd][0], rtol=2e-5)


def test_gpt2_train_pipeline(spawned):
    """``gpt2_train --pipeline_devices 2 --pp_microbatches 2`` on 2 ranks:
    finite val NLL and perplexity, the ranks alike; on a 1-layer model it
    fails JAX's ``n_layer >= n_stages`` check on both ranks."""
    keys = ("val_nll", "val_acc", "val_ppl")
    stats = spawned["cli"]
    assert np.isfinite(stats[0]["val_nll"])
    assert np.isfinite(stats[0]["val_ppl"])
    assert [stats[1][k] for k in keys] == [stats[0][k] for k in keys]
    for r in spawned["deep"]:
        assert "must be <= n_layer" in r["error"], r
