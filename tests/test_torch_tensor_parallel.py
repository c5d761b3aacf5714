"""The port's tensor parallelism for GPT-2 (the ``model`` axis of
``parallel/mesh.py``, ``models/gpt2.TPDense`` and ``tp_sliced_param``, the
round's ``tp_scale`` reconciliation) against the JAX package on its CPU
mesh, mirroring ``tests/test_tensor_parallel.py`` (``TestTPForward``,
``TestTPRound``, ``TestTPxSP``) at its sizes (V 128, T 16, C 32, L 2,
H 4).

Pure functions: the grid policy with model and expert axes against
``default_client_mesh`` (sizes and clamp warnings word for word, each
device's process rank against JAX's row-major device order),
``tp_sliced_param`` and the flat ``tp_scale`` mask against JAX's on the
flax paths, the streaming build's per-leaf scales against the flat masks
(and against JAX's ``sketch_grad_tree``), the weights carried across
unchanged, Ulysses with a model axis refused, the one-process degrade and
``cv_train``'s refusal.

On 2 and 4 ``gloo`` ranks (``tests/torch_dist_ranks.py``, one spawn; the
JAX side runs in the parent meanwhile):

- the tensor-parallel forward on 2 and 4 model ranks and the seq 2 x
  model 2 ring forward: LM and multiple-choice logits within
  ``atol=3e-5`` of JAX's under ``shard_map`` (its tolerance; ``3e-4`` for
  the ring forward, as there);
- two uncompressed rounds on (clients 2) x (model 2), through the fused
  client phase and the per-client path (``--max_grad_norm``), and on the
  (clients 1) x (seq 2) x (model 2) ring mesh, against JAX's rounds on
  the same meshes: weights and losses within ``rtol=atol=2e-5`` (JAX's
  ``TestTPRound`` tolerance), the val metrics too, every rank bit-equal;
- the other client phases on (clients 1) x (model 2): the streaming
  opt-in round (per-leaf scales, the table summed over the axis),
  sketch-space local state and fedavg, each within ``rtol=1e-4,
  atol=1e-6`` of the port's one-rank round (the seq tests' tolerances)
  with both ranks bit-equal;
- dropout under tensor parallelism: both model ranks draw the same keep
  masks, of the local-head size;
- ``gpt2_train`` on 2 ranks under ``--model_devices 2`` and on 4 under
  ``--seq_parallel ring --seq_devices 2 --model_devices 2``: finite val
  NLL, the ranks alike.
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
from jax.flatten_util import ravel_pytree  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from commefficient_tpu.compat import shard_map  # noqa: E402
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated.losses import (  # noqa: E402
    make_gpt2_losses as j_losses,
)
from commefficient_tpu.federated.worker import (  # noqa: E402
    sketch_grad_tree as j_sketch_grad_tree,
)
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JGPT2  # noqa: E402
from commefficient_tpu.models.gpt2 import (  # noqa: E402
    tp_sliced_param as j_tp_sliced,
)
from commefficient_tpu.ops import flat as jflat  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_tpu.parallel import mesh as JM  # noqa: E402
from commefficient_tpu.parallel import make_mesh  # noqa: E402
from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.federated import rounds as trounds  # noqa: E402
from commefficient_torch.federated.aggregator import (  # noqa: E402
    worker_config_from_args,
)
from commefficient_torch.federated.worker import sketch_grad_tree  # noqa: E402
from commefficient_torch.models.gpt2 import (  # noqa: E402
    GPT2DoubleHeads,
    tp_sliced_param,
)
from commefficient_torch.ops import flat as tflat  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.parallel import ClientGroup  # noqa: E402
from commefficient_torch.parallel import mesh as TM  # noqa: E402
from tests.torch_dist_ranks import start_ranks  # noqa: E402

V, T, E, L, H = 128, 16, 32, 2, 4
DIMS = dict(vocab_size=V, n_positions=T, n_embd=E, n_layer=L, n_head=H)
W, B, C, NCLIENTS, LR = 2, 2, 2, 8, 0.1
UNC = ["--mode", "uncompressed", "--error_type", "virtual",
       "--local_momentum", "0", "--virtual_momentum", "0.9"]
# the per-client path: a dense clip leaves no fused client phase
PER_CLIENT = UNC + ["--max_grad_norm", "1000"]
SKETCH = ["--mode", "sketch", "--error_type", "virtual",
          "--local_momentum", "0", "--virtual_momentum", "0.9",
          "--k", "2000", "--num_cols", "20000", "--num_rows", "5",
          "--num_blocks", "20"]
OTHER = {"opt-in": SKETCH + ["--stream_sketch", "--sketch_coalesce",
                             "--fused_epilogue"],
         "sketch-local": ["--mode", "sketch", "--error_type", "local",
                          "--local_momentum", "0.9", "--virtual_momentum",
                          "0", "--k", "2000", "--num_cols", "20000",
                          "--num_rows", "5", "--num_blocks", "20"],
         "fedavg": ["--mode", "fedavg", "--error_type", "none",
                    "--local_momentum", "0", "--virtual_momentum", "0.9",
                    "--fedavg_batch_size", "1"]}
# the JAX meshes of the round cases: (argv of the grid, JAX model kw)
JAX_GRIDS = {
    "fused": (UNC + ["--num_devices", "2", "--model_devices", "2"],
              dict(model_axis="model")),
    "per-client": (PER_CLIENT + ["--num_devices", "2", "--model_devices",
                                 "2"], dict(model_axis="model")),
    "seq x model": (UNC + ["--num_devices", "1", "--seq_parallel", "ring",
                           "--seq_devices", "2", "--model_devices", "2"],
                    dict(model_axis="model", attn_impl="ring")),
}


def _common():
    return ["--num_workers", str(W), "--num_clients", str(NCLIENTS),
            "--dataset_name", "PERSONA", "--local_batch_size", str(B),
            "--max_seq_len", str(T), "--seed", "0", "--no_telemetry"]


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
    jm = JGPT2(**DIMS, dropout=0.0, **kw)
    ids = jnp.zeros((1, C, T), jnp.int32)
    return jm.init(jax.random.key(0), ids, token_type_ids=ids,
                   mc_token_ids=jnp.zeros((1, C), jnp.int32),
                   train=False)["params"]


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def _jax_forward(params, spec, axes, **kw):
    """JAX's forward under ``shard_map`` over a mesh of ``axes``; the
    token axis sharded over ``seq`` when the mesh has one."""
    mesh = make_mesh(list(axes), devices=jax.devices()[:int(np.prod(
        [n for _, n in axes]))])
    model = JGPT2(**DIMS, dropout=0.0, **kw)
    seq = "seq" in dict(axes)
    tok = P(None, None, "seq") if seq else P()

    @partial(shard_map, mesh=mesh, in_specs=(tok, tok, P()),
             out_specs=(P(None, None, "seq", None) if seq else P(), P()),
             check_vma=False)
    def fwd(i, t, m):
        return model.apply({"params": params}, i, token_type_ids=t,
                           mc_token_ids=m, train=False)

    lm, mc = jax.jit(fwd)(jnp.asarray(spec["ids"]), jnp.asarray(spec["tti"]),
                          jnp.asarray(spec["mc"]))
    return np.asarray(lm), np.asarray(mc)


def _jax_rounds(argv, model_kw, params, batches, n_experts=0):
    """Two rounds of JAX's ``FedModel`` on the mesh ``argv`` asks for: per
    round the fetched results and the weights, then the val metrics."""
    jargs = j_parse(default_lr=4e-2, argv=argv + _common())
    kw = dict(model_kw)
    if n_experts:
        kw["n_experts"] = n_experts
    jm = JGPT2(**DIMS, dropout=0.0, **kw)
    seq = "seq" if kw.get("attn_impl", "dense") != "dense" else None
    jtrain, jval = j_losses(jm, seq_axis=seq,
                            moe_aux_coef=jargs.moe_aux_coef if n_experts
                            else 0.0)
    jfm = JFedModel(jm, jtrain, jargs, jval, num_clients=NCLIENTS,
                    init_params=params)
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    out = []
    for b in batches:
        res = jfm(b)
        jopt.step()
        out.append((res, np.asarray(ravel_pytree(jfm.params)[0])))
    jfm.train(False)
    return out, jfm(_val_batch()), dict(jfm.mesh.shape)


# --------------------------------------------------------------------------
# one spawn
# --------------------------------------------------------------------------

def _forward_spec():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, V, (2, 2, T)).astype(np.int64)
    tti = rng.randint(0, V, (2, 2, T)).astype(np.int64)
    mc = rng.randint(0, T, (2, 2)).astype(np.int64)
    params = _jax_params()
    return params, {"model": dict(DIMS, dropout=0.0), "ids": ids,
                    "tti": tti, "mc": mc,
                    "flat0": np.asarray(ravel_pytree(params)[0])}


def _run(argv, nd, seq=1, impl=None, **kw):
    # fedavg trains on each client's whole batch
    tail = ["--local_batch_size", "-1"] if "fedavg" in argv else []
    return dict({"argv": argv + _common() + ["--num_devices", str(nd)]
                 + tail, "num_devices": nd, "seq": seq, "impl": impl}, **kw)


def _rounds_spec(runs, params):
    return {"W": W, "model": DIMS, "num_clients": NCLIENTS, "lr": LR,
            "flat0": np.asarray(ravel_pytree(params)[0]),
            "batches": [_batch(r) for r in range(2)], "val": _val_batch(),
            "runs": runs}


def _cli(tmp, name, extra, k):
    return ("cli_gpt2_train", {
        "argv": ["--device", "cpu", "--num_epochs", "1", "--num_workers",
                 "2", "--local_batch_size", "2", "--max_seq_len", "32",
                 "--mode", "sketch", "--error_type", "virtual",
                 "--local_momentum", "0", "--virtual_momentum", "0.9",
                 "--k", "5000", "--num_cols", "20000", "--num_rows", "3",
                 "--num_blocks", "2", "--seed", "0", "--dataset_dir",
                 str(tmp / f"data_{name}"), "--num_devices", "1"] + extra,
        "env": {"COMMEFFICIENT_TINY_MODEL": "1",
                "COMMEFFICIENT_SYNTHETIC_CLIENTS": "8",
                "COMMEFFICIENT_RUN_DIR": str(tmp / f"run_{name}")}}, k)


TP = ["--model_devices", "2"]
RUNS4 = [_run(JAX_GRIDS["fused"][0], 2), _run(JAX_GRIDS["per-client"][0], 2),
         _run(JAX_GRIDS["seq x model"][0], 1, seq=2, impl="ring")]
RUNS2 = []
for _mode in OTHER.values():
    RUNS2 += [_run(_mode + TP, 1), _run(_mode, 1, single=True)]
RUNS2.append(_run(UNC + TP, 1, dropout=0.1))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 4 ranks runs every body of this file while the parent
    computes JAX's side."""
    tmp = tmp_path_factory.mktemp("tp")
    params = _jax_params()
    fwd_params, fwd = _forward_spec()
    batches = [_batch(r) for r in range(2)]
    items = [("body_mp_forward", dict(fwd, cases=[{"model": 2}]), 2),
             ("body_mp_forward", dict(fwd, cases=[
                 {"model": 4}, {"seq": 2, "model": 2, "impl": "ring"}]), 4),
             ("body_seq_rounds", _rounds_spec(RUNS4, params), 4),
             ("body_seq_rounds", _rounds_spec(RUNS2, params), 2),
             _cli(tmp, "tp", TP, 2),
             _cli(tmp, "3d", ["--seq_parallel", "ring", "--seq_devices", "2",
                              "--model_devices", "2"], 4)]
    with start_ranks(4, items, tmp) as ranks, ThreadPoolExecutor(3) as pool:
        jrounds = {key: pool.submit(_jax_rounds, argv, kw, params, batches)
                   for key, (argv, kw) in JAX_GRIDS.items()}
        jfwd = {nm: _jax_forward(fwd_params, fwd, [("model", nm)],
                                 model_axis="model") for nm in (2, 4)}
        jfwd["ring"] = _jax_forward(fwd_params, fwd,
                                    [("seq", 2), ("model", 2)],
                                    model_axis="model", attn_impl="ring")
        out = {"jrounds": {k: f.result() for k, f in jrounds.items()},
               "jfwd": jfwd, "fwd": (fwd_params, fwd), "params": params}
        outs = ranks.join()
    out.update(fwd2=outs[0], fwd4=outs[1], rounds4=outs[2], rounds2=outs[3],
               cli=(outs[4], outs[5]))
    return out


# --------------------------------------------------------------------------
# pure functions
# --------------------------------------------------------------------------

def _clamp_warnings(caught):
    return [str(w.message) for w in caught
            if str(w.message).startswith("--")]


@pytest.mark.parametrize(
    "num_workers,num_devices,shard,seq,model,expert,n_experts,world", [
        (4, -1, 1, 1, 2, 1, 0, 4), (2, 1, 1, 2, 2, 1, 0, 4),
        (4, -1, 1, 1, 2, 2, 4, 8), (2, 1, 1, 2, 2, 2, 4, 8),
        (2, -1, 1, 1, 4, 1, 0, 2), (2, -1, 1, 1, 1, 3, 4, 8),
        (4, -1, 2, 1, 2, 1, 0, 8), (2, -1, 1, 2, 2, 2, 2, 4),
        (4, 2, 1, 1, 1, 2, 2, 8)])
def test_grid_with_model_and_expert_is_the_jax_mesh_policy(
        num_workers, num_devices, shard, seq, model, expert, n_experts,
        world):
    """``grid_sizes`` against ``default_client_mesh`` with model and
    expert axes over ``world`` devices: every axis size, the clamp
    warnings word for word, and each device's process rank against JAX's
    row-major device order (``((p * Q + q) * M + m) * E + e``)."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        mesh = JM.default_client_mesh(
            num_workers, num_devices, devices=jax.devices()[:world],
            seq_devices=seq, model_devices=model, expert_devices=expert,
            n_experts=n_experts, shard_devices=shard)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = TM.grid_sizes(num_workers, num_devices, shard, world, seq,
                            model, expert, n_experts)
    shape = dict(mesh.shape)
    assert got == {a: shape.get(a, 1) for a in got}
    assert [a for a in got if got[a] > 1 or a == "clients"] == \
        list(mesh.axis_names)
    assert _clamp_warnings(tw) == _clamp_warnings(jw)
    sizes = [got[a] for a in ("clients", "shard", "seq", "model", "expert")]
    nc, nsh, ns, nm, ne = sizes
    devs = mesh.devices.reshape(sizes)
    for c, s, q, m, e in np.ndindex(*sizes):
        i = devs[c, s, q, m, e].id
        assert TM.tuple_index(i, nc, nsh, ns, nm, ne) == \
            (((s * nc + c) * ns + q) * nm + m) * ne + e


def test_tp_sliced_param_and_mask_match_jax():
    """``tp_sliced_param`` on every flax path of the model, and the flat
    ``tp_scale`` mask (``rounds.slice_scale_values`` / ``flat_scale`` over
    the port's leaf segments) bit-equal to the one JAX's round builds
    from its leaf segments (``rounds.py:494-515``), at 2 and 4 ranks."""
    params = _jax_params()
    jsegs = jflat.leaf_segments(params)
    tsegs = tflat.leaf_segments(tflat.ParamLayout(GPT2DoubleHeads(**DIMS)))
    assert [(s.path, s.offset, s.size) for s in tsegs] == \
        [(s.path, s.offset, s.size) for s in jsegs]
    assert [tp_sliced_param(s.path) for s in tsegs] == \
        [j_tp_sliced(s.path) for s in jsegs]
    assert sum(tp_sliced_param(s.path) for s in tsegs) == 6 * L
    for n in (2, 4):
        want = np.asarray(jnp.concatenate([
            jnp.full(s.size, 1.0 if j_tp_sliced(s.path) else 1.0 / n,
                     jnp.float32) for s in jsegs]))
        got = trounds.flat_scale(
            tsegs, trounds.slice_scale_values(tsegs, tp_sliced_param, n))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_stream_scales_match_the_flat_masks():
    """The streaming build's per-leaf scales: ``sketch_grad_tree`` with
    the product of the tp and ep values per leaf equals the sketch of the
    flat gradient times the two flat masks, and JAX's
    ``sketch_grad_tree`` with the same scales (the scales are powers of
    two: exact)."""
    from commefficient_torch.models.gpt2 import GPT2DoubleHeads as TG
    from commefficient_torch.parallel.moe import ep_sliced_param

    layout = tflat.ParamLayout(TG(**DIMS, n_experts=4))
    segs = tflat.leaf_segments(layout)
    tp = trounds.slice_scale_values(segs, tp_sliced_param, 2)
    ep = trounds.slice_scale_values(segs, ep_sliced_param, 2)
    scales = tuple(a * b for a, b in zip(tp, ep))
    assert set(scales) == {0.5, 0.25}
    rng = np.random.RandomState(5)
    grads = [rng.randn(*e.jax_shape).astype(np.float32)
             for e in layout.entries]
    d = layout.d
    ts = tsk.make_sketch(d, 2000, 3, seed=0, num_blocks=2, device="cpu")
    js = jsk.make_sketch(d, 2000, 3, seed=0, num_blocks=2)
    zero = torch.zeros(ts.table_shape)
    got = sketch_grad_tree(ts, zero, [torch.from_numpy(g) for g in grads],
                           segs, scales=scales)
    flat = torch.cat([torch.from_numpy(g).reshape(-1) for g in grads])
    mask = trounds.flat_scale(segs, tp) * trounds.flat_scale(segs, ep)
    want = tsk.sketch_vec(ts, flat * mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jgot = j_sketch_grad_tree(js, jnp.zeros(js.table_shape, jnp.float32),
                              [jnp.asarray(g) for g in grads],
                              jflat.leaf_segments(
                                  [np.zeros(g.shape) for g in grads]),
                              scales=scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6,
                               atol=1e-6)


def test_weights_carry_over_unchanged():
    """The tensor-parallel model's parameters are the dense model's: the
    same layout (names, JAX paths, kinds, shapes, d) and the same flat
    vector from a JAX tree; the keep-mask count takes the local heads."""
    params = _jax_params()
    flat = np.asarray(ravel_pytree(params)[0])
    dense = GPT2DoubleHeads(**DIMS, dropout=0.1)
    for nm in (2, 4):
        fake = ClientGroup(None, 0, nm, torch.device("cpu"))
        tp = GPT2DoubleHeads(**DIMS, dropout=0.1, model_group=fake)
        ld, lt = tflat.ParamLayout(dense), tflat.ParamLayout(tp)
        assert lt.d == ld.d == flat.size
        assert list(lt.entries) == list(ld.entries)
        np.testing.assert_array_equal(flat_from_jax(flat, lt).numpy(),
                                      flat_from_jax(flat, ld).numpy())
        tok = 4 * T * E
        assert tp.dropout_numel(4, T) == tok + L * (
            4 * (H // nm) * T * T + 2 * tok)


def test_ulysses_with_model_axis_rejected():
    """Ulysses with a model axis is refused at the model and at the CLI,
    with JAX's assertions."""
    fake = ClientGroup(None, 0, 2, torch.device("cpu"))
    with pytest.raises(AssertionError, match="ring"):
        GPT2DoubleHeads(**DIMS, attn_impl="ulysses", seq_group=fake,
                        model_group=fake)
    argv = ["--mode", "uncompressed", "--local_momentum", "0",
            "--model_devices", "2", "--seq_parallel", "ulysses"]
    for parse in (j_parse, partial(t_parse, None)):
        with pytest.raises(AssertionError, match="ring"):
            parse(argv=argv)


def test_degrades_gracefully_without_devices(tmp_path, monkeypatch):
    """``--model_devices 2`` in one process: the grid policy warns as
    JAX's does, the worker takes no model axis, and ``gpt2_train`` trains
    the dense model (its stats equal the run without the flag)."""
    with pytest.warns(UserWarning, match="--model_devices 2 reduced"):
        sizes = TM.grid_sizes(2, -1, world=1, model_devices=2)
    assert sizes["model"] == 1
    args = t_parse(argv=["--device", "cpu", "--mode", "uncompressed",
                         "--local_momentum", "0", "--model_devices", "2"])
    assert worker_config_from_args(args, None).model_axis is None
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
    argv = ["--device", "cpu", "--num_epochs", "0.3", "--num_workers", "2",
            "--local_batch_size", "2", "--max_seq_len", "32", "--mode",
            "uncompressed", "--error_type", "none", "--local_momentum", "0",
            "--seed", "0", "--dataset_dir", str(tmp_path / "d"),
            "--no_telemetry"]
    stats = []
    for extra in ([], TP):
        monkeypatch.setenv("COMMEFFICIENT_RUN_DIR",
                           str(tmp_path / f"run{len(extra)}"))
        with warnings.catch_warnings(record=True) as caught, \
                redirect_stdout(io.StringIO()):
            warnings.simplefilter("always")
            stats.append(gpt2_train.train(argv + extra))
        if extra:
            assert any("--model_devices 2 reduced to 1" in str(w.message)
                       for w in caught)
    keys = ("val_nll", "val_acc", "val_ppl")
    assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]


def test_cv_entrypoint_rejects_model_devices(tmp_path):
    """Tensor parallelism is GPT-2 only: ``cv_train`` raises the JAX
    package's assertion."""
    with pytest.raises(AssertionError, match="GPT-2 only"):
        cv_train.main(["--device", "cpu", "--dataset_name", "CIFAR10",
                       "--dataset_dir", str(tmp_path / "d"),
                       "--mode", "uncompressed", "--local_momentum", "0",
                       "--model_devices", "2"])


# --------------------------------------------------------------------------
# across ranks
# --------------------------------------------------------------------------

class TestTPForward:
    @pytest.mark.parametrize("nm", [2, 4])
    def test_logits_match_jax(self, spawned, nm):
        """The forward over ``nm`` model ranks: every rank's LM and
        multiple-choice logits against JAX's under ``shard_map`` and the
        port's dense forward (``atol=3e-5``, JAX's tolerance)."""
        _, spec = spawned["fwd"]
        got = [r[0] for r in spawned[f"fwd{nm}"]]
        jlm, jmc = spawned["jfwd"][nm]
        for r in got:
            np.testing.assert_allclose(r["lm"], jlm, atol=3e-5, rtol=3e-5)
            np.testing.assert_allclose(r["mc"], jmc, atol=3e-5, rtol=3e-5)
            np.testing.assert_array_equal(r["lm"], got[0]["lm"])


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


class TestTPRound:
    @pytest.mark.parametrize("i,phase", [(0, "fused"), (1, "per-client")])
    def test_round_matches_jax(self, spawned, i, phase):
        """Two uncompressed rounds on (clients 2) x (model 2), through the
        fused client phase and the per-client path, against JAX's rounds
        on its (clients 2, model 2) mesh: weights, losses and val metrics
        within ``2e-5``, the four ranks bit-equal."""
        ranks = [r[i] for r in spawned["rounds4"]]
        assert [(r["rank"], r["model"]) for r in ranks] == \
            [(0, (0, 2)), (0, (1, 2)), (1, (0, 2)), (1, (1, 2))]
        assert [r["process_rank"] for r in ranks] == [0, 1, 2, 3]
        assert all(r["model_axis"] == "model" and r["seq"] is None
                   for r in ranks)
        assert [a["name"] for a in ranks[0]["topology"]["axes"]] == \
            ["clients", "model"]
        assert [r["is_main"] for r in ranks] == [True, False, False, False]
        jout, jval, jshape = spawned["jrounds"][phase]
        assert jshape == {"clients": 2, "model": 2}
        flat0 = np.asarray(ravel_pytree(spawned["params"])[0])
        _check_trajectory(jout, jval, ranks, flat0, phase)

    @pytest.mark.parametrize("i,name", enumerate(OTHER))
    def test_other_client_phases(self, spawned, i, name):
        """The streaming opt-in round (per-leaf scales, its table summed
        over the model axis), sketch-space local state (per-client path)
        and fedavg's local SGD on (clients 1) x (model 2): both ranks
        bit-equal, within ``rtol=1e-4, atol=1e-6`` of the port's one-rank
        round with 0.99 of its kept set."""
        tp = [r[2 * i] for r in spawned["rounds2"]]
        single = spawned["rounds2"][0][2 * i + 1]
        assert tp[0]["model_axis"] == "model"
        flat0 = np.asarray(ravel_pytree(spawned["params"])[0])
        prev_t = prev_d = flat0
        for rnd in range(2):
            np.testing.assert_array_equal(tp[0]["w"][rnd].view(np.uint32),
                                          tp[1]["w"][rnd].view(np.uint32))
            wt, wd = tp[0]["w"][rnd], single["w"][rnd]
            np.testing.assert_allclose(wt, wd, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} round {rnd}")
            np.testing.assert_allclose(tp[0]["res"][rnd][0],
                                       single["res"][rnd][0], rtol=1e-4)
            a = set(np.flatnonzero(wt != prev_t))
            b = set(np.flatnonzero(wd != prev_d))
            assert len(a & b) >= 0.99 * max(len(a), len(b)), (name, rnd)
            prev_t, prev_d = wt, wd

    def test_dropout_masks_alike_on_model_ranks(self, spawned):
        """At dropout 0.1 the two model ranks draw the same keep masks,
        of the local-head size, and end bit-equal."""
        r0, r1 = (r[-1] for r in spawned["rounds2"])
        fake = ClientGroup(None, 0, 2, torch.device("cpu"))
        n = GPT2DoubleHeads(**DIMS, dropout=0.1,
                            model_group=fake).dropout_numel(B * C, T)
        for a, b in zip(r0["draws"], r1["draws"]):
            assert a.shape == (W, n)
            np.testing.assert_array_equal(a, b)
            assert 0.85 < a.mean() < 0.95
        np.testing.assert_array_equal(r0["w"][-1].view(np.uint32),
                                      r1["w"][-1].view(np.uint32))


class TestTPxSP:
    def test_logits_match_jax(self, spawned):
        """The seq 2 x model 2 ring forward: the LM logits concatenated
        over the seq ranks, and every rank's multiple-choice logits,
        against JAX's (``3e-4``, its tolerance)."""
        got = [r[1] for r in spawned["fwd4"]]
        jlm, jmc = spawned["jfwd"]["ring"]
        # ranks (q, m): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1)
        for m in (0, 1):
            lm = np.concatenate([got[m]["lm"], got[2 + m]["lm"]], axis=2)
            np.testing.assert_allclose(lm, jlm, atol=3e-4, rtol=3e-4)
        for r in got:
            np.testing.assert_allclose(r["mc"], jmc, atol=3e-4, rtol=3e-4)

    def test_round_matches_jax(self, spawned):
        """Two rounds on the (clients 1) x (seq 2) x (model 2) ring mesh
        against JAX's on its (clients 1, seq 2, model 2) mesh within
        ``2e-5``, the four ranks bit-equal."""
        ranks = [r[2] for r in spawned["rounds4"]]
        assert [(r["seq"], r["model"]) for r in ranks] == \
            [((0, 2), (0, 2)), ((0, 2), (1, 2)), ((1, 2), (0, 2)),
             ((1, 2), (1, 2))]
        assert all(r["seq_axis"] == "seq" and r["model_axis"] == "model"
                   for r in ranks)
        jout, jval, jshape = spawned["jrounds"]["seq x model"]
        assert jshape == {"clients": 1, "seq": 2, "model": 2}
        flat0 = np.asarray(ravel_pytree(spawned["params"])[0])
        _check_trajectory(jout, jval, ranks, flat0, "seq x model")


def test_gpt2_train_meshes(spawned):
    """``gpt2_train`` on 2 ranks under ``--model_devices 2`` and on 4
    under ``--seq_parallel ring --seq_devices 2 --model_devices 2``:
    finite val NLL and perplexity, the ranks alike."""
    keys = ("val_nll", "val_acc", "val_ppl")
    for stats in spawned["cli"]:
        assert np.isfinite(stats[0]["val_nll"])
        assert np.isfinite(stats[0]["val_ppl"])
        for s in stats[1:]:
            assert [s[k] for k in keys] == [stats[0][k] for k in keys]
