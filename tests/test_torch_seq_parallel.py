"""The port's sequence parallelism for GPT-2 (``parallel/ring.py``,
``parallel/ulysses.py``, the ``seq`` axis of ``parallel/mesh.py``, the
seq-parallel GPT-2 forward and losses, the round's seq split and sums)
against the JAX package on its CPU mesh, mirroring ``tests/test_parallel.py``
(``TestRingAttention``, ``TestUlyssesAttention``, ``TestGPT2SeqParallel``).

Pure functions: the grid policy with a seq axis against
``default_client_mesh`` (sizes and clamp warnings word for word), the
process numbering against JAX's device order, the collate's
``lm_labels_shifted`` bit for bit, the weights carried across unchanged.

On 2 and 4 ``gloo`` ranks (``tests/torch_dist_ranks.py``, one spawn; the
JAX side runs in the parent meanwhile):

- ring and Ulysses attention, causal and not, at B 2, T 32, H 8, D 16 on
  2 and 4 ranks: outputs within ``atol=1e-5`` and the ``q``/``k``/``v``
  gradients within ``atol=1e-4`` of JAX's ``make_ring_attention`` /
  ``make_ulysses_attention`` (fp32 sums in another order: the blockwise
  online softmax against XLA's);
- the seq-parallel GPT-2 forward (LM and multiple-choice logits) under
  both on 2 and 4 ranks, against JAX's under ``shard_map`` and against
  the port's dense model, within ``atol=2e-5`` (the forward's fp32 order);
- two sketch rounds under each attention (clients 1 x seq 2), at dropout
  0, against JAX's seq-parallel round on its (clients 1, seq 2) mesh:
  losses ``rtol=1e-4``, weights ``rtol=1e-4, atol=1e-6``, the kept sets
  overlapping by 0.99 (the tolerances of ``tests/test_torch_gpt2_rounds.py``,
  whose reasons hold here: the gradient is summed in another order), and
  given the port's round table, JAX's and the port's estimates, top-k
  threshold and kept set bit for bit; both ranks' weights bit-equal, and
  within ``rtol=1e-5, atol=1e-7`` of the port's one-rank dense round;
- the 2 x 2 (clients x seq) grid: two rounds on 4 ranks against JAX's
  (clients 2, seq 2) mesh with the same tolerances, all four ranks
  bit-equal;
- degradation at seq 1 (``--seq_devices 1`` on 2 ranks): no seq axis and
  the round bit-equal to the run without the flag; one process prints
  ``--seq_parallel ring disabled`` as JAX's ``gpt2_train`` does;
- dropout under seq parallelism: the seq ranks draw different masks of
  the local slice's size, and the round generator stays replicated;
- ``gpt2_train`` on 2 ranks under ``--seq_parallel ring`` and
  ``ulysses`` (finite val NLL, the ranks agree);
- ``cv_train``: under ``--seq_parallel ring`` on a (clients 1, seq 2)
  mesh the JAX package's CV round doubles the gradient (a CV batch has
  no sequence to split); the port refuses the flag.
"""

import io
import os
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
from commefficient_tpu.data_utils.fed_persona import (  # noqa: E402
    make_personachat_collate_fn as j_collate,
)
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated.losses import (  # noqa: E402
    make_gpt2_losses as j_losses,
)
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JGPT2  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_tpu.parallel import mesh as JM  # noqa: E402
from commefficient_tpu.parallel import (  # noqa: E402
    make_mesh,
    make_ring_attention,
    make_ulysses_attention,
)
from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.data_utils.fed_persona import (  # noqa: E402
    make_personachat_collate_fn as t_collate,
)
from commefficient_torch.models.gpt2 import GPT2DoubleHeads  # noqa: E402
from commefficient_torch.ops import flat as tflat  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.parallel import ClientGroup  # noqa: E402
from commefficient_torch.parallel import mesh as TM  # noqa: E402
from tests.torch_dist_ranks import start_ranks  # noqa: E402

TINY = dict(vocab_size=512, n_positions=64, n_embd=64, n_layer=2, n_head=2)
FWD = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=4)
B, C, T, NCLIENTS, LR = 2, 2, 32, 8, 0.05
SKETCH = ["--mode", "sketch", "--error_type", "virtual",
          "--local_momentum", "0", "--virtual_momentum", "0.9",
          "--k", "2000", "--num_cols", "20000", "--num_rows", "5",
          "--num_blocks", "20"]


def _common(W):
    return ["--num_workers", str(W), "--num_clients", str(NCLIENTS),
            "--dataset_name", "PERSONA", "--local_batch_size", str(B),
            "--max_seq_len", str(T), "--seed", "0", "--no_telemetry"]


def _seq(impl, nd, ns):
    return ["--num_devices", str(nd)] + (
        ["--seq_parallel", impl, "--seq_devices", str(ns)] if impl else [])


def _batch(rnd, W):
    rng = np.random.RandomState(70 + rnd)
    lm = rng.randint(0, TINY["vocab_size"], (W, B, C, T)).astype(np.int64)
    lm[..., :T // 3] = -1
    shifted = np.full_like(lm, -1)
    shifted[..., :-1] = lm[..., 1:]
    mask = np.ones((W, B), np.float32)
    if rnd == 1:
        mask[0, 1] = 0.0  # a short client
    return {
        "input_ids": rng.randint(0, TINY["vocab_size"], (W, B, C, T)),
        "token_type_ids": rng.randint(0, TINY["vocab_size"], (W, B, C, T)),
        "lm_labels": lm, "lm_labels_shifted": shifted,
        "mc_token_ids": rng.randint(0, T, (W, B, C)),
        "mc_labels": rng.randint(0, C, (W, B)), "mask": mask,
        "client_ids": rng.choice(NCLIENTS, W, replace=False).astype(
            np.int32),
        "worker_mask": np.ones(W, np.float32)}


def _val_batch():
    b = _batch(9, 1)
    out = {k: v[0] for k, v in b.items()
           if k not in ("client_ids", "worker_mask", "mask")}
    out["mask"] = np.ones(B, np.float32)
    return out


def _jax_params(model_kw):
    jm = JGPT2(**model_kw, dropout=0.0)
    ids = jnp.zeros((1, C, T), jnp.int32)
    return jm.init(jax.random.key(0), ids, token_type_ids=ids,
                   mc_token_ids=jnp.zeros((1, C), jnp.int32),
                   train=False)["params"]


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def _seq_mesh(n):
    return make_mesh([("seq", n)], devices=jax.devices()[:n])


def _jax_attention(c):
    mesh = _seq_mesh(c["n"])
    make = {"ring": make_ring_attention,
            "ulysses": make_ulysses_attention}[c["impl"]]
    attn = make(mesh, causal=c["causal"])
    q, k, v, ct = (jnp.asarray(c[x]) for x in ("q", "k", "v", "ct"))
    out = attn(q, k, v)
    grads = jax.grad(lambda a, b, d: (attn(a, b, d) * ct).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_forward(params, spec, impl, n):
    sp = JGPT2(**FWD, dropout=0.0, attn_impl=impl)
    seq = P(None, None, "seq")

    @partial(shard_map, mesh=_seq_mesh(n), in_specs=(seq, seq, P(None, None)),
             out_specs=(P(None, None, "seq", None), P(None, None)),
             check_vma=False)
    def fwd(i, t, m):
        return sp.apply({"params": params}, i, token_type_ids=t,
                        mc_token_ids=m, train=False)

    lm, mc = jax.jit(fwd)(jnp.asarray(spec["ids"]), jnp.asarray(spec["tti"]),
                          jnp.asarray(spec["mc"]))
    return np.asarray(lm), np.asarray(mc)


def _jax_rounds(impl, nd, ns, W, params, batches):
    argv = SKETCH + _common(W) + _seq(impl, nd, ns)
    jargs = j_parse(default_lr=4e-2, argv=argv)
    jm = JGPT2(**TINY, dropout=0.0, attn_impl=impl)
    jtrain, jval = j_losses(jm, seq_axis="seq")
    jfm = JFedModel(jm, jtrain, jargs, jval, num_clients=NCLIENTS,
                    init_params=params)
    assert dict(jfm.mesh.shape) == {"clients": nd, "seq": ns}
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    out = []
    for b in batches:
        res = jfm(b)
        jopt.step()
        out.append((res, np.asarray(ravel_pytree(jfm.params)[0])))
    jfm.train(False)
    return out, jfm(_val_batch())


def _jax_cv_delta(seq):
    """One uncompressed round of the tiny Dense model on a (clients 1,
    seq 2) mesh, or without the seq axis: the weight change."""
    import flax.linen as nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            return nn.Dense(4, use_bias=False)(x)

    def loss(params, model_state, batch, rng, train):
        err = Tiny().apply({"params": params}, batch["inputs"]) \
            - batch["targets"]
        return jnp.sum(jnp.square(err).mean(-1) * batch["mask"]), (), \
            jnp.sum(batch["mask"]), model_state

    argv = ["--mode", "uncompressed", "--error_type", "none",
            "--local_momentum", "0", "--virtual_momentum", "0",
            "--weight_decay", "0", "--num_workers", "2", "--num_devices",
            "1", "--num_clients", "4", "--local_batch_size", "2",
            "--seed", "0", "--no_telemetry"]
    if seq:
        argv += ["--seq_parallel", "ring", "--seq_devices", "2"]
    args = j_parse(argv=argv)
    rs = np.random.RandomState(5)
    w0 = rs.randn(3, 4).astype(np.float32)
    fm = JFedModel(Tiny(), loss, args, input_shape=(3,),
                   init_params={"Dense_0": {"kernel": jnp.asarray(w0)}})
    assert dict(fm.mesh.shape) == ({"clients": 1, "seq": 2} if seq
                                   else {"clients": 1})
    opt = JFedOptimizer(fm, args)
    opt.set_lr_factor(0.5)
    fm({"inputs": rs.randn(2, 2, 3).astype(np.float32),
        "targets": rs.randn(2, 2, 4).astype(np.float32),
        "mask": np.ones((2, 2), np.float32),
        "client_ids": np.arange(2, dtype=np.int32),
        "worker_mask": np.ones(2, np.float32)})
    opt.step()
    return np.asarray(ravel_pytree(fm.params)[0]) - w0.reshape(-1)


# --------------------------------------------------------------------------
# one spawn
# --------------------------------------------------------------------------

def _attention_cases(n):
    rng = np.random.RandomState(0)
    shape = (2, 32, 8, 16)
    q, k, v, ct = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    return [{"impl": impl, "causal": causal, "n": n, "q": q, "k": k, "v": v,
             "ct": ct}
            for impl in ("ring", "ulysses") for causal in (True, False)]


def _forward_spec():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, FWD["vocab_size"], (2, 2, T)).astype(np.int64)
    tti = rng.randint(0, FWD["vocab_size"], (2, 2, T)).astype(np.int64)
    mc = rng.randint(0, T, (2, 2)).astype(np.int64)
    jm = JGPT2(**FWD, dropout=0.0)
    params = jm.init(jax.random.key(0), jnp.asarray(ids),
                     token_type_ids=jnp.asarray(tti),
                     mc_token_ids=jnp.asarray(mc), train=False)["params"]
    return params, {"model": dict(FWD, dropout=0.0), "ids": ids, "tti": tti,
                    "mc": mc, "impls": ("ring", "ulysses"),
                    "flat0": np.asarray(ravel_pytree(params)[0])}


def _rounds_spec(W, runs, params, batches):
    return {"W": W, "model": TINY, "num_clients": NCLIENTS, "lr": LR,
            "flat0": np.asarray(ravel_pytree(params)[0]),
            "batches": batches, "val": _val_batch(), "runs": runs}


def _run(impl, nd, ns, W, mode=SKETCH, **kw):
    # fedavg trains on each client's whole batch
    tail = (["--local_batch_size", "-1"] if "fedavg" in mode else [])
    return dict({"argv": mode + _common(W) + _seq(impl, nd, ns) + tail,
                 "num_devices": nd, "seq": ns, "impl": impl}, **kw)


# the other client phases under seq parallelism: the streaming opt-in
# round, the per-client path (sketch-space local error and momentum) and
# fedavg's local SGD
OTHER = {"opt-in": SKETCH + ["--stream_sketch", "--sketch_coalesce",
                             "--fused_epilogue"],
         "sketch-local": ["--mode", "sketch", "--error_type", "local",
                          "--local_momentum", "0.9", "--virtual_momentum",
                          "0", "--k", "2000", "--num_cols", "20000",
                          "--num_rows", "5", "--num_blocks", "20"],
         "fedavg": ["--mode", "fedavg", "--error_type", "none",
                    "--local_momentum", "0", "--virtual_momentum", "0.9",
                    "--fedavg_batch_size", "1"]}


def _cli(tmp, impl):
    return {"argv": ["--device", "cpu", "--num_epochs", "1",
                     "--num_workers", "2", "--local_batch_size", "2",
                     "--max_seq_len", "32", "--mode", "sketch",
                     "--error_type", "virtual", "--local_momentum", "0",
                     "--virtual_momentum", "0.9", "--k", "5000",
                     "--num_cols", "20000", "--num_rows", "3",
                     "--num_blocks", "2", "--seed", "0", "--dataset_dir",
                     str(tmp / f"data_{impl}"), "--num_devices", "1",
                     "--seq_parallel", impl, "--seq_devices", "2"],
            "env": {"COMMEFFICIENT_TINY_MODEL": "1",
                    "COMMEFFICIENT_SYNTHETIC_CLIENTS": "8",
                    "COMMEFFICIENT_RUN_DIR": str(tmp / f"run_{impl}")}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 4 ranks runs every body of this file while the parent
    computes JAX's side."""
    tmp = tmp_path_factory.mktemp("seq")
    params = _jax_params(TINY)
    b2 = [_batch(r, 2) for r in range(2)]
    b4 = [_batch(r, 4) for r in range(2)]
    runs2 = [_run("ring", 1, 2, 2), _run("ulysses", 1, 2, 2),
             _run(None, 1, 1, 2, single=True),
             _run("ring", 2, 1, 2), _run(None, 2, 1, 2),
             _run("ring", 1, 2, 2, dropout=0.1)]
    for mode in OTHER.values():
        runs2 += [_run("ring", 1, 2, 2, mode), _run(None, 1, 1, 2, mode,
                                                     single=True)]
    fwd_params, fwd = _forward_spec()
    items = [("body_seq_attention", _attention_cases(2), 2),
             ("body_seq_attention", _attention_cases(4), 4),
             ("body_seq_forward", fwd, 2), ("body_seq_forward", fwd, 4),
             ("body_seq_rounds", _rounds_spec(2, runs2, params, b2), 2),
             ("body_seq_rounds", _rounds_spec(
                 4, [_run("ring", 2, 2, 4)], params, b4), 4),
             ("cli_gpt2_train", _cli(tmp, "ring"), 2),
             ("cli_gpt2_train", _cli(tmp, "ulysses"), 2)]
    with start_ranks(4, items, tmp) as ranks, ThreadPoolExecutor(3) as pool:
        jatt = [pool.submit(_jax_attention, c)
                for n in (2, 4) for c in _attention_cases(n)]
        jrounds = {key: pool.submit(_jax_rounds, *key, params,
                                    b2 if key[3] == 2 else b4)
                   for key in (("ring", 1, 2, 2), ("ulysses", 1, 2, 2),
                               ("ring", 2, 2, 4))}
        jfwd = {(impl, n): _jax_forward(fwd_params, fwd, impl, n)
                for impl in ("ring", "ulysses") for n in (2, 4)}
        jcv = {seq: _jax_cv_delta(seq) for seq in (False, True)}
        out = {"jatt": [f.result() for f in jatt],
               "jrounds": {k: f.result() for k, f in jrounds.items()},
               "jfwd": jfwd, "jcv": jcv, "fwd": (fwd_params, fwd),
               "params": params, "b2": b2, "b4": b4}
        outs = ranks.join()
    out.update(att2=outs[0], att4=outs[1], fwd2=outs[2], fwd4=outs[3],
               rounds2=outs[4], rounds4=outs[5], cli=(outs[6], outs[7]))
    return out


# --------------------------------------------------------------------------
# pure functions
# --------------------------------------------------------------------------

def _clamp_warnings(caught):
    return [str(w.message) for w in caught
            if str(w.message).startswith("--")]


@pytest.mark.parametrize("num_workers,num_devices,shard,seq,world", [
    (4, -1, 1, 2, 4), (4, 1, 1, 2, 2), (4, 2, 1, 2, 8), (2, -1, 1, 4, 2),
    (8, -1, 2, 2, 8), (4, -1, 1, 3, 8), (2, 4, 1, 2, 8), (4, 1, 1, 1, 2)])
def test_grid_with_seq_is_the_jax_mesh_policy(num_workers, num_devices,
                                              shard, seq, world):
    """``grid_axes`` against ``default_client_mesh`` with a seq axis over
    ``world`` devices: the clients, shard and seq sizes, the clamp
    warnings word for word, and each device's process rank against JAX's
    device order (seq minor-most)."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        mesh = JM.default_client_mesh(num_workers, num_devices,
                                      devices=jax.devices()[:world],
                                      seq_devices=seq, shard_devices=shard)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = TM.grid_axes(num_workers, num_devices, shard, world, seq)
    shape = dict(mesh.shape)
    want = (shape["clients"], shape.get("shard", 1), shape.get("seq", 1))
    assert got == want
    assert _clamp_warnings(tw) == _clamp_warnings(jw)
    assert TM.grid_shape(num_workers, num_devices, shard, world, seq) == \
        got[:2]
    nc, nsh, ns = got
    devs = mesh.devices.reshape(nc, nsh, ns)
    for c in range(nc):
        for s in range(nsh):
            for q in range(ns):
                i = devs[c, s, q].id
                assert TM.tuple_index(i, nc, nsh, ns) == \
                    (s * nc + c) * ns + q
    if ns == 1:
        assert [TM.tuple_index(i, nc, nsh, 1) for i in range(nc * nsh)] == \
            [TM.tuple_index(i, nc, nsh) for i in range(nc * nsh)]


def test_collate_emits_shifted_labels():
    """``make_personachat_collate_fn(emit_shifted=True)``: every array,
    ``lm_labels_shifted`` included, bit-equal to the JAX package's; the
    default adds no key."""
    rng = np.random.RandomState(2)
    items = []
    for _ in range(3):
        n = rng.randint(1, 4)
        lens = rng.randint(5, 50, n)
        ids = [list(rng.randint(0, 300, L)) for L in lens]
        items.append((ids, [L - 1 for L in lens],
                      [list(np.where(rng.rand(L) < 0.5, -1,
                                     rng.randint(0, 300, L)))
                       for L in lens],
                      int(rng.randint(0, n)),
                      [list(rng.randint(0, 300, L)) for L in lens]))
    for shifted in (True, False):
        want = j_collate(40, 3, emit_shifted=shifted)(items)
        got = t_collate(40, 3, emit_shifted=shifted)(items)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert "lm_labels_shifted" not in t_collate(40, 3)(items)


def test_weights_carry_over_unchanged():
    """The seq-parallel model's parameters are the dense model's: the
    same layout (names, JAX paths, kinds, shapes, d), and the same flat
    vector from a JAX tree (``flat_from_jax``); the keep-mask count drops
    the attention term and counts the local slice."""
    params = _jax_params(TINY)
    flat = np.asarray(ravel_pytree(params)[0])
    dense = GPT2DoubleHeads(**TINY, dropout=0.1)
    fake = ClientGroup(None, 0, 2, torch.device("cpu"))
    for impl in ("ring", "ulysses"):
        sp = GPT2DoubleHeads(**TINY, dropout=0.1, attn_impl=impl,
                             seq_group=fake)
        ld, ls = tflat.ParamLayout(dense), tflat.ParamLayout(sp)
        assert ls.d == ld.d == flat.size
        assert list(ls.entries) == list(ld.entries)
        np.testing.assert_array_equal(flat_from_jax(flat, ls).numpy(),
                                      flat_from_jax(flat, ld).numpy())
        tok = 4 * (T // 2) * TINY["n_embd"]
        assert sp.dropout_numel(4, T // 2) == tok + TINY["n_layer"] * 2 * tok
    with pytest.raises(AssertionError, match="seq group"):
        GPT2DoubleHeads(**TINY, attn_impl="ring")


def test_cv_train_refuses_seq_parallel(spawned):
    """A CV batch has no sequence to split: JAX's round on a (clients 1,
    seq 2) mesh sums each seq shard's whole gradient, so its weight
    change is twice the plain round's (weight decay 0; ``rtol=1e-6``:
    one multiply by the learning rate rounds either way); the port's
    ``cv_train`` refuses the flag."""
    plain, seq = spawned["jcv"][False], spawned["jcv"][True]
    assert np.abs(plain).max() > 0
    np.testing.assert_allclose(seq, 2 * plain, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="no sequence to split"):
        cv_train.main(["--device", "cpu", "--seq_parallel", "ring"])


def test_one_process_disables_seq_parallel(tmp_path, monkeypatch):
    """One process cannot hold a seq axis: ``gpt2_train`` warns as the
    grid policy does, prints ``--seq_parallel ring disabled`` and trains
    the dense model: its stats equal the run without the flag."""
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
    argv = ["--device", "cpu", "--num_epochs", "0.3", "--num_workers", "2",
            "--local_batch_size", "2", "--max_seq_len", "32", "--mode",
            "uncompressed", "--error_type", "none", "--local_momentum", "0",
            "--seed", "0", "--dataset_dir", str(tmp_path / "d"),
            "--no_telemetry"]
    stats = []
    for extra in ([], ["--seq_parallel", "ring"]):
        monkeypatch.setenv("COMMEFFICIENT_RUN_DIR",
                           str(tmp_path / f"run{len(extra)}"))
        buf = io.StringIO()
        with warnings.catch_warnings(record=True) as caught, \
                redirect_stdout(buf):
            warnings.simplefilter("always")
            stats.append(gpt2_train.train(argv + extra))
        if extra:
            assert "--seq_parallel ring disabled: mesh has no seq axis " \
                "({'clients': 1})" in buf.getvalue()
            assert any("--seq_devices 2 reduced to 1" in str(w.message)
                       for w in caught)
    keys = ("val_nll", "val_acc", "val_ppl")
    assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]


# --------------------------------------------------------------------------
# across ranks
# --------------------------------------------------------------------------

def _cat(per_rank, axis=1):
    return np.concatenate(per_rank, axis=axis)


@pytest.mark.parametrize("n", [2, 4])
def test_attention_matches_jax(spawned, n):
    """Ring and Ulysses attention, causal and not: the ranks' outputs and
    their ``q``/``k``/``v`` gradient slices, concatenated in rank order,
    against JAX's on an n-device seq mesh."""
    cases = _attention_cases(n)
    got = spawned[f"att{n}"]
    want = spawned["jatt"][:4] if n == 2 else spawned["jatt"][4:]
    for i, c in enumerate(cases):
        what = f"{c['impl']} causal={c['causal']} n={n}"
        jout, jgrads = want[i]
        np.testing.assert_allclose(_cat([r[i]["out"] for r in got]), jout,
                                   atol=1e-5, rtol=1e-5, err_msg=what)
        for j, name in enumerate("qkv"):
            np.testing.assert_allclose(
                _cat([r[i]["grads"][j] for r in got]), jgrads[j],
                atol=1e-4, rtol=1e-4, err_msg=f"{what} d{name}")


@pytest.mark.parametrize("n", [2, 4])
def test_gpt2_forward_matches_jax_and_dense(spawned, n):
    """The seq-parallel forward's LM logits (concatenated over the ranks)
    and multiple-choice logits (every rank) against JAX's seq-parallel
    forward under ``shard_map`` and the port's dense model."""
    params, spec = spawned["fwd"]
    dense = GPT2DoubleHeads(**FWD, dropout=0.0)
    layout = tflat.ParamLayout(dense)
    with torch.no_grad():
        lm_d, mc_d = torch.func.functional_call(
            dense, layout.params(flat_from_jax(spec["flat0"], layout)),
            (torch.from_numpy(spec["ids"]),),
            {"token_type_ids": torch.from_numpy(spec["tti"]),
             "mc_token_ids": torch.from_numpy(spec["mc"])})
    for impl in spec["impls"]:
        ranks = [r[impl] for r in spawned[f"fwd{n}"]]
        lm = np.concatenate([r["lm"] for r in ranks], axis=2)
        jlm, jmc = spawned["jfwd"][(impl, n)]
        for ref, what in ((jlm, "jax"), (lm_d.numpy(), "dense")):
            np.testing.assert_allclose(lm, ref, atol=2e-5, rtol=2e-5,
                                       err_msg=f"{impl} n={n} vs {what}")
        for r in ranks:
            np.testing.assert_allclose(r["mc"], jmc, atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(r["mc"], mc_d.numpy(), atol=2e-5,
                                       rtol=2e-5)


def _check_trajectory(jout, jval, ranks, flat0, what):
    jprev = tprev = flat0
    for rnd, (jres, jw) in enumerate(jout):
        for r in ranks:
            np.testing.assert_allclose(r["res"][rnd][0], jres[0], rtol=1e-4,
                                       err_msg=f"{what} loss {rnd}")
            np.testing.assert_array_equal(r["res"][rnd][2], jres[2])
        tw = ranks[0]["w"][rnd]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["w"][rnd].view(np.uint32),
                                          tw.view(np.uint32),
                                          err_msg=f"{what} ranks {rnd}")
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} round {rnd}")
        jsel = set(np.flatnonzero(jw != jprev))
        tsel = set(np.flatnonzero(tw != tprev))
        assert len(jsel & tsel) >= 0.99 * max(len(jsel), len(tsel)), \
            (what, rnd)
        jprev, tprev = jw, tw
    for r in ranks:
        np.testing.assert_allclose(r["val"][0], jval[0], rtol=1e-4)
        np.testing.assert_array_equal(r["val"][1], jval[1])


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sketch_round_matches_jax(spawned, impl):
    """Two sketch rounds on (clients 1, seq 2) against JAX's, the ranks
    bit-equal; the exact server math on the port's round table; the
    round within ``rtol=1e-5, atol=1e-7`` of the port's one-rank dense
    round (the attention's fp32 order)."""
    i = {"ring": 0, "ulysses": 1}[impl]
    ranks = [r[i] for r in spawned["rounds2"]]
    for q, r in enumerate(ranks):
        assert (r["rank"], r["size"], r["seq"], r["is_main"]) == \
            (0, 1, (q, 2), q == 0)
        assert r["seq_axis"] == "seq"
        assert r["topology"]["axes"][-1] == {"name": "seq", "size": 2,
                                            "placement": "ici"}
        assert r["topology"]["process_count"] == 2
    flat0 = np.asarray(ravel_pytree(spawned["params"])[0])
    jout, jval = spawned["jrounds"][(impl, 1, 2, 2)]
    _check_trajectory(jout, jval, ranks, flat0, impl)
    single = spawned["rounds2"][0][2]
    for rnd in range(2):
        np.testing.assert_allclose(ranks[0]["w"][rnd], single["w"][rnd],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ranks[0]["table"][rnd],
                                   single["table"][rnd], rtol=1e-4,
                                   atol=1e-6)
    # the server math on the port's table: exact in both packages
    table = ranks[0]["table"][0]
    d = flat0.size
    js = jsk.make_sketch(d, 20000, 5, seed=0, num_blocks=20)
    ts = tsk.make_sketch(d, 20000, 5, seed=0, num_blocks=20, device="cpu")
    jupd = np.asarray(jsk.unsketch_chunks(js, jnp.asarray(table), 2000))
    tupd = tsk.unsketch_chunks(ts, torch.from_numpy(table), 2000).numpy()
    np.testing.assert_array_equal(tupd.view(np.uint32), jupd.view(np.uint32))
    assert (tupd != 0).sum() >= 2000


def test_clients_by_seq_grid_matches_jax(spawned):
    """The 2 x 2 (clients x seq) grid: 4 slots over 2 tuple indices, each
    on 2 seq ranks, two rounds against JAX's (clients 2, seq 2) mesh; all
    four ranks bit-equal."""
    ranks = [r[0] for r in spawned["rounds4"]]
    assert [(r["rank"], r["seq"]) for r in ranks] == \
        [(0, (0, 2)), (0, (1, 2)), (1, (0, 2)), (1, (1, 2))]
    assert [a["name"] for a in ranks[0]["topology"]["axes"]] == \
        ["clients", "seq"]
    jout, jval = spawned["jrounds"][("ring", 2, 2, 4)]
    flat0 = np.asarray(ravel_pytree(spawned["params"])[0])
    _check_trajectory(jout, jval, ranks, flat0, "2x2")


def test_seq_one_degrades_to_the_dense_round(spawned):
    """``--seq_parallel ring --seq_devices 1`` on 2 ranks: no seq axis,
    the worker takes none, and every round equals the same grid's run
    without the flag bit for bit."""
    flagged, plain = spawned["rounds2"][0][3], spawned["rounds2"][0][4]
    assert flagged["seq"] is None and flagged["seq_axis"] is None
    for a, b in zip(flagged["w"], plain["w"]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("i,name", enumerate(OTHER))
def test_other_client_phases_under_seq(spawned, i, name):
    """The streaming opt-in round (its table summed over seq), the
    per-client path (each client's gradient summed over seq before its
    sketch-space carries) and fedavg's local SGD (each local step's
    gradient summed over seq): the two ranks bit-equal, and within
    ``rtol=1e-4, atol=1e-6`` of the port's one-rank round with 0.99 of
    its kept set (the gradient's fp32 order; the kept set can swap
    coordinates at the top-k cut)."""
    seq = [r[6 + 2 * i] for r in spawned["rounds2"]]
    single = spawned["rounds2"][0][7 + 2 * i]
    assert seq[0]["seq_axis"] == "seq"
    flat0 = np.asarray(ravel_pytree(spawned["params"])[0])
    prev_s = prev_d = flat0
    for rnd in range(2):
        np.testing.assert_array_equal(seq[0]["w"][rnd].view(np.uint32),
                                      seq[1]["w"][rnd].view(np.uint32))
        ws, wd = seq[0]["w"][rnd], single["w"][rnd]
        np.testing.assert_allclose(ws, wd, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name} round {rnd}")
        np.testing.assert_allclose(seq[0]["res"][rnd][0],
                                   single["res"][rnd][0], rtol=1e-4)
        a = set(np.flatnonzero(ws != prev_s))
        b = set(np.flatnonzero(wd != prev_d))
        assert len(a & b) >= 0.99 * max(len(a), len(b)), (name, rnd)
        prev_s, prev_d = ws, wd


def test_dropout_masks_differ_per_seq_rank(spawned):
    """At dropout 0.1 the two seq ranks draw their own keep masks for
    their slice (the local T, no attention-probs term), and the round
    generator moves on alike on both."""
    r0, r1 = (r[5] for r in spawned["rounds2"])
    m = GPT2DoubleHeads(**TINY, dropout=0.1,
                        attn_impl="ring",
                        seq_group=ClientGroup(None, 0, 2,
                                              torch.device("cpu")))
    n = m.dropout_numel(B * C, T // 2)
    for a, b in zip(r0["draws"], r1["draws"]):
        assert a.shape == b.shape == (2, n)
        assert (a != b).mean() > 0.1
        assert 0.85 < a.mean() < 0.95
    np.testing.assert_array_equal(r0["rng_state"], r1["rng_state"])
    np.testing.assert_array_equal(r0["w"][-1].view(np.uint32),
                                  r1["w"][-1].view(np.uint32))


def test_gpt2_train_under_seq_parallel(spawned):
    """``gpt2_train`` on 2 gloo ranks under ``--seq_parallel ring`` and
    ``ulysses``: finite val NLL and perplexity, the two ranks alike."""
    keys = ("val_nll", "val_acc", "val_ppl")
    for stats in spawned["cli"]:
        assert np.isfinite(stats[0]["val_nll"])
        assert np.isfinite(stats[0]["val_ppl"])
        assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]
