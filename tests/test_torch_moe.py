"""The port's mixture of experts and expert parallelism for GPT-2
(``parallel/moe.py``: ``MoEMLP``, ``ep_sliced_param``; the MoE blocks of
``models/gpt2.py``; the ``expert`` axis of ``parallel/mesh.py``; the
round's ``ep_scale`` reconciliation; ``--moe_aux_coef``) against the JAX
package, mirroring ``tests/test_moe.py`` (``TestMoEMLP``,
``TestMoEModel``, ``TestEPRound``, ``TestEPWiring``, ``TestSPxEP``,
``TestTPxEP``) at its sizes (V 128, T 16, C 32, L 2, H 4, 4 experts; the
module cases at C 8).

In one process: ``MoEMLP``'s output, aux and gradients against JAX's on
the same leaves (``atol=rtol=1e-5``, its tolerance; the aux
``rtol=1e-6``) and against the hand-written Switch rule; sparse dispatch
equal to dense at ``capacity_factor = E``, and at 1.25 dropping exactly
the tokens JAX's drops (the zero rows of both outputs, and the port's
``kept_tokens``, are one set); the overflow drop with a rigged router;
the FLOP count of ``torch.utils.flop_counter`` (sparse below half of
dense, JAX's compiled-FLOPs case); ``ep_sliced_param`` and the flat
``ep_scale`` mask against JAX's on every flax path; the every-other-block
layout, the forward, the aux and the loss with its gradient under
``moe_aux_coef`` against JAX's; ``load_hf_gpt2``'s warning; the flags'
checks, the grid's expert clamp and ``cv_train``'s refusal.

On 2, 4 and 8 ``gloo`` ranks (``tests/torch_dist_ranks.py``, one spawn;
the JAX side runs in the parent meanwhile):

- ``MoEMLP`` sharded over 2 and 4 expert ranks (dense, and sparse at full
  capacity), over a seq axis of 2 (the aux global) and over seq 2 x
  expert 2: outputs, aux and gradients against JAX's unsharded module
  (which JAX's own tests hold its sharded module to);
- the MoE forward over 2 and 4 expert ranks against JAX's;
- two rounds, aux on, of (clients 2) x (expert 2) (fused and per-client),
  (clients 1) x (seq 2) x (expert 2), (clients 1) x (model 2) x (expert
  2) (fused and per-client) and the 4-D (clients 1) x (seq 2) x (model 2)
  x (expert 2) against JAX's rounds on the same meshes: weights, losses
  and val metrics within ``rtol=atol=2e-5``, every rank bit-equal, and
  the experts and router moved;
- ``gpt2_train`` under ``--n_experts 2 --expert_devices 2`` with dense
  and sparse dispatch, with ``--seq_parallel ring --seq_devices 2`` and
  with ``--model_devices 2``: finite val NLL, the ranks alike.
"""

import functools
import io
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.models import gpt2 as JG  # noqa: E402
from commefficient_tpu.federated.losses import (  # noqa: E402
    make_gpt2_losses as j_losses,
)
from commefficient_tpu.ops import flat as jflat  # noqa: E402
from commefficient_tpu.parallel import mesh as JM  # noqa: E402
from commefficient_tpu.parallel.moe import MoEMLP as JMoE  # noqa: E402
from commefficient_tpu.parallel.moe import (  # noqa: E402
    ep_sliced_param as j_ep_sliced,
)
from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    flax_from_port,
    params_from_flax,
)
from commefficient_torch.federated import rounds as trounds  # noqa: E402
from commefficient_torch.federated.losses import (  # noqa: E402
    make_gpt2_losses as t_losses,
)
from commefficient_torch.models.gpt2 import (  # noqa: E402
    GPT2DoubleHeads,
    load_hf_gpt2,
)
from commefficient_torch.ops import flat as tflat  # noqa: E402
from commefficient_torch.parallel import mesh as TM  # noqa: E402
from commefficient_torch.parallel.moe import (  # noqa: E402
    MoEMLP,
    ep_sliced_param,
)
from tests.test_torch_tensor_parallel import (  # noqa: E402
    DIMS,
    PER_CLIENT,
    UNC,
    _batch,
    _check_trajectory,
    _cli,
    _jax_rounds,
    _rounds_spec,
    _run,
)
from tests.torch_dist_ranks import start_ranks  # noqa: E402

V, T, E, L, H = 128, 16, 32, 2, 4
NEXP = 4
MOE = ["--n_experts", str(NEXP), "--moe_aux_coef", "0.01"]


@functools.lru_cache(maxsize=None)
def _jax_params(**kw):
    jm = JG.GPT2DoubleHeads(**DIMS, dropout=0.0, n_experts=NEXP, **kw)
    ids = jnp.zeros((1, 2, T), jnp.int32)
    return jm.init(jax.random.key(0), ids, token_type_ids=ids,
                   mc_token_ids=jnp.zeros((1, 2), jnp.int32),
                   train=False)["params"]


def _mlp_case(C=8, nexp=4, shape=(2, 8), seed=0):
    """JAX-initialized ``MoEMLP`` leaves, an input and an output
    cotangent (numpy)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, C).astype(np.float32)
    params = JMoE(C, nexp).init(jax.random.key(seed + 1),
                                jnp.asarray(x))["params"]
    return ({k: np.asarray(v) for k, v in params.items()}, x,
            rng.randn(*shape, C).astype(np.float32))


def _port_mlp(params, C, nexp, **kw):
    mod = MoEMLP(C, nexp, **kw)
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(v)))
    return mod


def _jax_mlp(params, x, ct, nexp, **kw):
    """JAX's unsharded ``MoEMLP``: output, aux, and the gradients of
    ``sum(out * ct) + aux`` by the input and every leaf."""
    mod = JMoE(x.shape[-1], nexp, **kw)

    def f(p, xx):
        out, sown = mod.apply({"params": p}, xx, mutable=["moe_losses"])
        (aux,) = sown["moe_losses"]["aux"]
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return {"out": np.asarray(out), "aux": float(aux), "gx": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}}


def _port_grads(mod, x, ct):
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = mod(xt)
    names = sorted(n for n, _ in mod.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum() + aux,
                                [xt] + [getattr(mod, n) for n in names])
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "gx": grads[0].numpy(),
            "grads": {n: g.numpy() for n, g in zip(names, grads[1:])}}


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(got["out"], want["out"], atol=tol, rtol=tol,
                               err_msg=what)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6,
                               err_msg=what)
    np.testing.assert_allclose(got["gx"], want["gx"], atol=tol, rtol=tol,
                               err_msg=what)
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                   atol=tol, rtol=tol, err_msg=f"{what} {k}")


# --------------------------------------------------------------------------
# one spawn
# --------------------------------------------------------------------------

# the module cases across ranks: (ranks, cases)
MLP_CASES = {2: [{"expert": 2}, {"expert": 2, "dispatch": "sparse",
                                  "cf": 4.0}, {"seq": 2}],
             4: [{"expert": 4}, {"expert": 4, "dispatch": "sparse",
                                  "cf": 4.0}, {"seq": 2, "expert": 2}]}
# the round cases: (argv, JAX model kw, ranks)
EP = ["--expert_devices", "2"]
ROUNDS = {
    "ep fused": (UNC + MOE + EP + ["--num_devices", "2"],
                 dict(expert_axis="expert")),
    "ep per-client": (PER_CLIENT + MOE + EP + ["--num_devices", "2"],
                      dict(expert_axis="expert")),
    "seq x expert": (UNC + MOE + EP + ["--num_devices", "1",
                                       "--seq_parallel", "ring",
                                       "--seq_devices", "2"],
                     dict(expert_axis="expert", attn_impl="ring")),
    "model x expert fused": (UNC + MOE + EP + ["--num_devices", "1",
                                               "--model_devices", "2"],
                             dict(expert_axis="expert", model_axis="model")),
    "model x expert per-client": (
        PER_CLIENT + MOE + EP + ["--num_devices", "1", "--model_devices",
                                 "2"],
        dict(expert_axis="expert", model_axis="model")),
}
FOUR_D = (UNC + MOE + EP + ["--num_devices", "1", "--seq_parallel", "ring",
                            "--seq_devices", "2", "--model_devices", "2"],
          dict(expert_axis="expert", model_axis="model", attn_impl="ring"))


def _round_run(argv, kw):
    impl = kw.get("attn_impl")
    return _run(argv[:argv.index("--num_devices")] + argv[
        argv.index("--num_devices") + 2:], int(argv[argv.index(
            "--num_devices") + 1]), seq=2 if impl else 1, impl=impl)


def _forward_spec(params):
    rng = np.random.RandomState(3)
    return {"model": dict(DIMS, dropout=0.0, n_experts=NEXP),
            "ids": rng.randint(0, V, (2, 2, T)).astype(np.int64),
            "tti": rng.randint(0, V, (2, 2, T)).astype(np.int64),
            "mc": rng.randint(0, T, (2, 2)).astype(np.int64),
            "flat0": np.asarray(ravel_pytree(params)[0])}


def _jax_forward(params, spec):
    jm = JG.GPT2DoubleHeads(**DIMS, dropout=0.0, n_experts=NEXP)
    (lm, mc), sown = jm.apply(
        {"params": params}, jnp.asarray(spec["ids"]),
        token_type_ids=jnp.asarray(spec["tti"]),
        mc_token_ids=jnp.asarray(spec["mc"]), train=False,
        mutable=["moe_losses"])
    aux = [float(a) for a in jax.tree_util.tree_leaves(sown["moe_losses"])]
    return np.asarray(lm), np.asarray(mc), aux


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 8 ranks runs every body of this file (the 4-D round
    last, the only item on all 8) while the parent computes JAX's
    side."""
    tmp = tmp_path_factory.mktemp("moe")
    params = _jax_params()
    batches = [_batch(r) for r in range(2)]
    mlp_params, x, ct = _mlp_case()
    mlp = {"params": mlp_params, "x": x, "ct": ct, "n_experts": 4}
    fwd = _forward_spec(params)
    runs = [_round_run(*ROUNDS[k]) for k in ROUNDS]
    items = [("body_moe_mlp", dict(mlp, cases=MLP_CASES[2]), 2),
             ("body_moe_mlp", dict(mlp, cases=MLP_CASES[4]), 4),
             ("body_mp_forward", dict(fwd, cases=[{"expert": 2}]), 2),
             ("body_mp_forward", dict(fwd, cases=[{"expert": 4}]), 4),
             ("body_seq_rounds", _rounds_spec(runs, params), 4),
             _cli(tmp, "ep_dense", ["--n_experts", "2", "--expert_devices",
                                    "2"], 2),
             _cli(tmp, "ep_sparse", ["--n_experts", "2", "--expert_devices",
                                     "2", "--moe_dispatch", "sparse"], 2),
             _cli(tmp, "sp_ep", ["--n_experts", "2", "--expert_devices", "2",
                                 "--seq_parallel", "ring", "--seq_devices",
                                 "2"], 4),
             _cli(tmp, "tp_ep", ["--n_experts", "2", "--expert_devices", "2",
                                 "--model_devices", "2"], 4),
             ("body_seq_rounds", _rounds_spec([_round_run(*FOUR_D)],
                                                  params), 8)]
    with start_ranks(8, items, tmp, timeout=150) as ranks, \
            ThreadPoolExecutor(4) as pool:
        jrounds = {key: pool.submit(_jax_rounds, argv, kw, params, batches,
                                    NEXP)
                   for key, (argv, kw) in dict(ROUNDS, **{
                       "4-D": FOUR_D}).items()}
        jmlp = {}
        for dispatch, cf in (("dense", 1.25), ("sparse", 4.0)):
            jmlp[dispatch] = _jax_mlp(mlp_params, x, ct, 4,
                                      dispatch=dispatch, capacity_factor=cf)
        jfwd = _jax_forward(params, fwd)
        out = {"jrounds": {k: f.result() for k, f in jrounds.items()},
               "jmlp": jmlp, "jfwd": jfwd, "mlp": mlp, "params": params}
        outs = ranks.join()
    out.update(mlp2=outs[0], mlp4=outs[1], fwd2=outs[2], fwd4=outs[3],
               rounds=outs[4], cli=outs[5:9], rounds8=outs[9])
    return out


# --------------------------------------------------------------------------
# in one process
# --------------------------------------------------------------------------

class TestMoEMLP:
    @pytest.mark.parametrize("dispatch,cf", [("dense", 1.25),
                                             ("sparse", 4.0)])
    def test_matches_jax_and_manual_top1(self, dispatch, cf):
        """Output, aux and gradients against JAX's module on the same
        leaves, and the output against the hand-written Switch rule: each
        token through its argmax expert's MLP, weighted by that expert's
        softmax probability (sparse at full capacity is the same)."""
        params, x, ct = _mlp_case(seed=0)
        mod = _port_mlp(params, 8, 4, dispatch=dispatch, capacity_factor=cf)
        got = _port_grads(mod, x, ct)
        _close(got, _jax_mlp(params, x, ct, 4, dispatch=dispatch,
                             capacity_factor=cf), what=dispatch)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ params["router"]),
                                          axis=-1))
        want = np.zeros_like(x)
        for b, t in np.ndindex(*x.shape[:2]):
            e = int(np.argmax(probs[b, t]))
            h = np.asarray(jax.nn.gelu(jnp.asarray(
                x[b, t] @ params["w_fc"][e] + params["b_fc"][e]),
                approximate=True))
            want[b, t] = probs[b, t, e] * (h @ params["w_proj"][e]
                                           + params["b_proj"][e])
        np.testing.assert_allclose(got["out"], want, atol=1e-5, rtol=1e-5)

    def test_aux_loss_matches_manual(self):
        """The aux equals ``E * sum_e f_e * P_e`` by hand, and is at least
        1 (its value at perfectly balanced routing)."""
        params, x, _ = _mlp_case(seed=5, shape=(2, 6))
        with torch.no_grad():
            _, aux = _port_mlp(params, 8, 4)(torch.from_numpy(x))
        probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ params["router"]),
                                          axis=-1)).reshape(-1, 4)
        f = np.bincount(probs.argmax(-1), minlength=4) / probs.shape[0]
        np.testing.assert_allclose(float(aux),
                                   4 * float((f * probs.mean(0)).sum()),
                                   rtol=1e-6)
        assert float(aux) >= 1.0 - 1e-6

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sparse_drops_the_tokens_jax_drops(self, seed):
        """At capacity factor 1.25 on a batch where experts overflow: the
        port's and JAX's outputs are zero on one set of tokens (the
        dropped ones, ``kept_tokens``'s complement, some of them), and
        agree elsewhere, gradients included."""
        params, x, ct = _mlp_case(seed=10 + seed, shape=(2, 16))
        mod = _port_mlp(params, 8, 4, dispatch="sparse",
                        capacity_factor=1.25)
        got = _port_grads(mod, x, ct)
        want = _jax_mlp(params, x, ct, 4, dispatch="sparse",
                        capacity_factor=1.25)
        _close(got, want, what=f"seed {seed}")
        zero_t = np.all(got["out"] == 0, axis=-1)
        zero_j = np.all(want["out"] == 0, axis=-1)
        np.testing.assert_array_equal(zero_t, zero_j)
        kept = mod.kept_tokens(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(~kept, zero_j)
        assert 0 < zero_j.sum() < zero_j.size

    def test_sparse_dispatch_drops_overflow_tokens(self):
        """With every token routed to expert 0 and capacity 1, only the
        first token in order survives; the others' outputs are zero."""
        params, x, _ = _mlp_case(seed=7, shape=(1, 8), nexp=2)
        x = np.abs(x)
        params["router"] = np.zeros_like(params["router"])
        params["router"][:, 0] = 1.0
        mod = _port_mlp(params, 8, 2, dispatch="sparse",
                        capacity_factor=0.25)
        out, _ = mod(torch.from_numpy(x))
        out = out.detach().numpy()[0]
        assert np.abs(out[0]).sum() > 0
        np.testing.assert_array_equal(out[1:], 0.0)

    def test_sparse_dispatch_gradients_flow(self):
        params, x, ct = _mlp_case(seed=11, shape=(2, 4))
        got = _port_grads(_port_mlp(params, 8, 4, dispatch="sparse",
                                    capacity_factor=4.0), x, ct)
        for k in ("router", "w_fc", "w_proj"):
            assert np.abs(got["grads"][k]).sum() > 0, k

    def test_sparse_dispatch_cuts_flops(self):
        """``torch.utils.flop_counter`` of the forward at C 64, 8 experts,
        256 tokens, capacity factor 1: sparse below half of dense (dense
        pays every expert for every token)."""
        from torch.utils.flop_counter import FlopCounterMode

        x = torch.from_numpy(np.random.RandomState(13).randn(
            4, 64, 64).astype(np.float32))

        def flops(dispatch):
            mod = MoEMLP(64, 8, dispatch=dispatch, capacity_factor=1.0)
            with torch.no_grad():
                for p in mod.parameters():
                    p.normal_(0, 0.02)
            with FlopCounterMode(display=False) as fc:
                mod(x)
            return fc.get_total_flops()

        f_dense, f_sparse = flops("dense"), flops("sparse")
        assert f_sparse < f_dense / 2, (f_dense, f_sparse)

    def test_ep_sliced_param_and_mask_match_jax(self):
        """``ep_sliced_param`` on every flax path of the MoE model (the
        router and expert leaves, and nothing else), and the flat
        ``ep_scale`` mask bit-equal to the one JAX's round builds."""
        assert ep_sliced_param("h1/moe/w_fc")
        assert ep_sliced_param("h1/moe/router")
        assert not ep_sliced_param("h1/attn_qkv/kernel")
        params = _jax_params()
        jsegs = jflat.leaf_segments(params)
        tsegs = tflat.leaf_segments(tflat.ParamLayout(
            GPT2DoubleHeads(**DIMS, n_experts=NEXP)))
        assert [(s.path, s.offset, s.size) for s in tsegs] == \
            [(s.path, s.offset, s.size) for s in jsegs]
        assert [ep_sliced_param(s.path) for s in tsegs] == \
            [j_ep_sliced(s.path) for s in jsegs]
        assert sum(ep_sliced_param(s.path) for s in tsegs) == 5
        for n in (2, 4):
            want = np.asarray(jnp.concatenate([
                jnp.full(s.size, 1.0 if j_ep_sliced(s.path) else 1.0 / n,
                         jnp.float32) for s in jsegs]))
            got = trounds.flat_scale(tsegs, trounds.slice_scale_values(
                tsegs, ep_sliced_param, n))
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32))


class TestMoEModel:
    def test_moe_every_other_block(self):
        """Blocks 1, 3, ... carry ``moe`` and no dense MLP: the port's
        layout is JAX's tree (paths, shapes, d) and a JAX flat vector
        loads into it in the same ravel order."""
        params = _jax_params()
        m = GPT2DoubleHeads(**DIMS, n_experts=NEXP)
        assert m.moe_blocks == [1]
        assert hasattr(m.h1, "moe") and not hasattr(m.h1, "mlp_fc")
        assert hasattr(m.h0, "mlp_fc") and not hasattr(m.h0, "moe")
        layout = tflat.ParamLayout(m)
        flat = np.asarray(ravel_pytree(params)[0])
        assert layout.d == flat.size
        tree = flax_from_port(layout.params(flat_from_jax(flat, layout)),
                              layout)
        for (path, leaf) in jax.tree_util.tree_leaves_with_path(params):
            keys = [p.key for p in path]
            node = tree
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node, np.asarray(leaf))
        assert tree["h1"]["moe"]["w_fc"].shape == (NEXP, E, 4 * E)
        # and the flax tree itself crosses into the modules' layout
        back = layout.flatten(params_from_flax(
            jax.tree_util.tree_map(np.asarray, params), layout))
        np.testing.assert_array_equal(back.numpy(), flat)

    def test_forward_and_aux_match_jax(self):
        """Logits and the aux of each MoE layer against JAX's forward and
        its sown ``moe_losses``."""
        params = _jax_params()
        spec = _forward_spec(params)
        m = GPT2DoubleHeads(**DIMS, dropout=0.0, n_experts=NEXP)
        layout = tflat.ParamLayout(m)
        with torch.no_grad():
            lm, mc, aux = torch.func.functional_call(
                m, layout.params(flat_from_jax(spec["flat0"], layout)),
                (torch.from_numpy(spec["ids"]),),
                {"token_type_ids": torch.from_numpy(spec["tti"]),
                 "mc_token_ids": torch.from_numpy(spec["mc"]),
                 "return_aux": True})
        jlm, jmc, jaux = _jax_forward(params, spec)
        np.testing.assert_allclose(lm.numpy(), jlm, atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(mc.numpy(), jmc, atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(aux.numpy(), jaux, rtol=1e-6)

    @pytest.mark.parametrize("dispatch", ["dense", "sparse"])
    def test_loss_and_gradient_match_jax(self, dispatch):
        """The train loss with ``moe_aux_coef`` 0.01 and its gradient
        against JAX's ``make_gpt2_losses`` on one client's batch."""
        params = _jax_params()
        flat = np.asarray(ravel_pytree(params)[0])
        b = {k: v[0] for k, v in _batch(0).items()
             if k not in ("client_ids", "worker_mask")}
        jm = JG.GPT2DoubleHeads(**DIMS, dropout=0.0, n_experts=NEXP,
                                moe_dispatch=dispatch)
        jtrain, _ = j_losses(jm, moe_aux_coef=0.01)
        _, unravel = ravel_pytree(params)
        jb = {k: jnp.asarray(v) for k, v in b.items()}

        def jloss(w):
            return jtrain(unravel(w), {}, jb, jax.random.key(0), True)[0]

        jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(flat))
        m = GPT2DoubleHeads(**DIMS, dropout=0.0, n_experts=NEXP,
                            moe_dispatch=dispatch)
        layout = tflat.ParamLayout(m)
        ttrain, _ = t_losses(m, moe_aux_coef=0.01)
        leaves = layout.leaves(flat_from_jax(flat, layout))
        tl = ttrain(layout.params_of(leaves), {},
                    {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
                    None, True)[0]
        tg = layout.gather_grads(torch.autograd.grad(tl, leaves),
                                 torch.empty(layout.d))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5,
                                   rtol=1e-4)
        # the aux moved the loss: without it the loss is smaller
        plain, _ = t_losses(m)
        assert float(plain(layout.params_of(leaves), {}, {
            k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
            None, True)[0]) < float(tl)


class TestEPWiring:
    def test_degrades_gracefully_without_devices(self, tmp_path,
                                                 monkeypatch):
        """``--n_experts 4 --expert_devices 2`` in one process: the grid
        policy warns as JAX's does, ``gpt2_train`` prints
        ``--expert_devices 2 disabled`` and trains the unsharded MoE
        model (its stats equal the run without the flag)."""
        with pytest.warns(UserWarning, match="--expert_devices 2 reduced"):
            sizes = TM.grid_sizes(2, -1, world=1, expert_devices=2,
                                  n_experts=4)
        assert sizes["expert"] == 1
        monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
        monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
        argv = ["--device", "cpu", "--num_epochs", "0.3", "--num_workers",
                "2", "--local_batch_size", "2", "--max_seq_len", "32",
                "--mode", "uncompressed", "--error_type", "none",
                "--local_momentum", "0", "--seed", "0", "--dataset_dir",
                str(tmp_path / "d"), "--no_telemetry", "--n_experts", "4"]
        stats = []
        for extra in ([], ["--expert_devices", "2"]):
            monkeypatch.setenv("COMMEFFICIENT_RUN_DIR",
                               str(tmp_path / f"run{len(extra)}"))
            buf = io.StringIO()
            with warnings.catch_warnings(record=True), redirect_stdout(buf):
                warnings.simplefilter("always")
                stats.append(gpt2_train.train(argv + extra))
            if extra:
                assert "--expert_devices 2 disabled: mesh has no expert " \
                    "axis ({'clients': 1})" in buf.getvalue()
        keys = ("val_nll", "val_acc", "val_ppl")
        assert [stats[0][k] for k in keys] == [stats[1][k] for k in keys]

    def test_cv_entrypoint_rejects_n_experts(self, tmp_path):
        with pytest.raises(AssertionError, match="GPT-2 only"):
            cv_train.main(["--device", "cpu", "--dataset_name", "CIFAR10",
                           "--dataset_dir", str(tmp_path / "d"),
                           "--mode", "uncompressed", "--local_momentum",
                           "0", "--n_experts", "4"])

    def test_validate_args_invariants(self):
        """The flags' checks, as JAX's: ``--expert_devices`` needs
        ``--n_experts`` and must divide it; the pipeline's flags parse as
        JAX's (ported with item 7.4), so the MoE flags compose with
        them."""
        base = ["--mode", "uncompressed", "--local_momentum", "0"]
        for parse in (j_parse, t_parse):
            with pytest.raises(AssertionError, match="requires --n_experts"):
                parse(argv=base + ["--expert_devices", "2"])
            with pytest.raises(AssertionError, match="must divide"):
                parse(argv=base + ["--n_experts", "3", "--expert_devices",
                                   "2"])
        args = t_parse(argv=base + ["--n_experts", "4", "--expert_devices",
                                    "2", "--moe_dispatch", "sparse",
                                    "--moe_capacity_factor", "2.0",
                                    "--moe_aux_coef", "0"])
        assert (args.n_experts, args.expert_devices, args.moe_dispatch,
                args.moe_capacity_factor, args.moe_aux_coef) == \
            (4, 2, "sparse", 2.0, 0.0)
        argv = base + ["--n_experts", "4", "--pipeline_devices", "2"]
        ta, ja = t_parse(argv=argv), j_parse(argv=argv)
        assert (ta.pipeline_devices, ta.pp_microbatches, ta.n_experts) == \
            (ja.pipeline_devices, ja.pp_microbatches, ja.n_experts)

    def test_mesh_degrade_keeps_expert_divisibility(self):
        """Clamping lands on a divisor of ``n_experts`` (3 asked of 8
        devices with 4 experts gives 2), with JAX's warning word for
        word."""
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            mesh = JM.default_client_mesh(2, -1, devices=jax.devices()[:8],
                                          expert_devices=3, n_experts=4)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            sizes = TM.grid_sizes(2, -1, world=8, expert_devices=3,
                                  n_experts=4)
        assert sizes["expert"] == mesh.shape["expert"] == 2
        assert [str(w.message) for w in tw] == \
            [str(w.message) for w in jw if str(w.message).startswith("--")]
        assert any("must divide --n_experts 4" in str(w.message)
                   for w in tw)

    def test_load_hf_gpt2_warns_on_moe_blocks(self, tmp_path, capsys):
        """An HF checkpoint loaded into the MoE model says which blocks
        keep their experts, loads the rest, and leaves the experts as in
        the template."""
        m = GPT2DoubleHeads(**DIMS, n_experts=NEXP)
        layout = tflat.ParamLayout(m)
        template = flax_from_port(layout.params(flat_from_jax(
            np.asarray(ravel_pytree(_jax_params())[0]), layout)), layout)
        state = {"transformer.wte.weight": torch.zeros(V, E),
                 "transformer.wpe.weight": torch.zeros(T, E),
                 "transformer.ln_f.weight": torch.ones(E),
                 "transformer.ln_f.bias": torch.zeros(E)}
        for i in range(L):
            p = f"transformer.h.{i}."
            for ln in ("ln_1", "ln_2"):
                state[p + ln + ".weight"] = torch.ones(E)
                state[p + ln + ".bias"] = torch.zeros(E)
            for name, shape in (("attn.c_attn", (E, 3 * E)),
                                ("attn.c_proj", (E, E)),
                                ("mlp.c_fc", (E, 4 * E)),
                                ("mlp.c_proj", (4 * E, E))):
                state[p + name + ".weight"] = torch.zeros(shape)
                state[p + name + ".bias"] = torch.zeros(shape[1])
        torch.save(state, tmp_path / "pytorch_model.bin")
        loaded = load_hf_gpt2(template, str(tmp_path))
        assert "blocks [1] are MoE" in capsys.readouterr().out
        np.testing.assert_array_equal(loaded["h1"]["moe"]["w_fc"],
                                      template["h1"]["moe"]["w_fc"])
        assert np.abs(loaded["h1"]["moe"]["w_fc"]).max() > 0
        assert np.abs(loaded["h0"]["mlp_fc"]["kernel"]).max() == 0
        assert np.abs(loaded["h1"]["attn_qkv"]["kernel"]).max() == 0


# --------------------------------------------------------------------------
# across ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_moe_mlp_matches_jax(spawned, n):
    """``MoEMLP`` over ``n`` ranks: experts over the expert axis (dense,
    and sparse at full capacity), the tokens over a seq axis (the aux
    global), and seq 2 x expert 2: every rank's output (its tokens),
    aux and gradients against JAX's unsharded module; the input and leaf
    gradients summed over the ranks where each holds a part."""
    jd, js = spawned["jmlp"]["dense"], spawned["jmlp"]["sparse"]
    T_ = spawned["mlp"]["x"].shape[1]
    for i, c in enumerate(MLP_CASES[n]):
        got = [r[i] for r in spawned[f"mlp{n}"]]
        want = js if c.get("dispatch") == "sparse" else jd
        nsq = c.get("seq", 1)
        ne = c.get("expert", 1)
        what = str(c)
        for rank, g in enumerate(got):
            q = rank // ne
            sl = slice(q * T_ // nsq, (q + 1) * T_ // nsq)
            np.testing.assert_allclose(g["out"], want["out"][:, sl],
                                       atol=1e-5, rtol=1e-5, err_msg=what)
            np.testing.assert_allclose(g["aux"], want["aux"], rtol=1e-6,
                                       err_msg=what)
            np.testing.assert_allclose(g["gx"], want["gx"][:, sl],
                                       atol=1e-5, rtol=1e-5, err_msg=what)
        # every leaf is expert-sliced or token-partial: the ranks' parts
        # sum to the whole gradient (scale 1)
        for k, jg in want["grads"].items():
            assert ep_sliced_param(f"h1/moe/{k}")
            np.testing.assert_allclose(sum(g["grads"][k] for g in got), jg,
                                       atol=2e-5, rtol=1e-4,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("n", [2, 4])
def test_moe_forward_matches_jax(spawned, n):
    """The MoE GPT-2 forward over ``n`` expert ranks: every rank's logits
    and aux against JAX's unsharded forward."""
    jlm, jmc, jaux = spawned["jfwd"]
    for r in spawned[f"fwd{n}"]:
        np.testing.assert_allclose(r[0]["lm"], jlm, atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(r[0]["mc"], jmc, atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(r[0]["aux"], jaux, rtol=1e-6)


def _round_ranks(spawned, key):
    if key == "4-D":
        return [r[0] for r in spawned["rounds8"]]
    i = list(ROUNDS).index(key)
    return [r[i] for r in spawned["rounds"]]


@pytest.mark.parametrize("key", list(ROUNDS) + ["4-D"])
def test_round_matches_jax(spawned, key):
    """Two rounds with the aux on, against JAX's rounds on the same mesh
    (``TestEPRound``, ``TestSPxEP``, ``TestTPxEP`` and its 4-D round):
    weights, losses and val metrics within ``2e-5``, every rank
    bit-equal, and the experts and the router moved."""
    ranks = _round_ranks(spawned, key)
    jout, jval, jshape = spawned["jrounds"][key]
    assert all(r["expert_axis"] == "expert" for r in ranks)
    topo = ranks[0]["topology"]
    assert {a["name"]: a["size"] for a in topo["axes"]} == jshape
    assert [a["name"] for a in topo["axes"]] == list(jshape)
    assert sorted(r["process_rank"] for r in ranks) == \
        list(range(len(ranks)))
    flat0 = np.asarray(ravel_pytree(spawned["params"])[0])
    _check_trajectory(jout, jval, ranks, flat0, key)
    m = GPT2DoubleHeads(**DIMS, n_experts=NEXP)
    layout = tflat.ParamLayout(m)
    moved = {e.jax_path[-1]: np.abs(ranks[0]["w"][0][e.offset:e.offset
                                                     + e.size]
                                    - flat0[e.offset:e.offset + e.size]
                                    ).max()
             for e in layout.entries if e.jax_path[1] == "moe"}
    assert moved["router"] > 0 and moved["w_fc"] > 0, moved


def test_gpt2_train_meshes(spawned):
    """``gpt2_train`` under ``--n_experts 2 --expert_devices 2`` (dense and
    sparse dispatch, 2 ranks), with ``--seq_parallel ring --seq_devices
    2`` and with ``--model_devices 2`` (4 ranks): finite val NLL and
    perplexity, the ranks alike."""
    keys = ("val_nll", "val_acc", "val_ppl")
    for stats in spawned["cli"]:
        assert np.isfinite(stats[0]["val_nll"])
        assert np.isfinite(stats[0]["val_ppl"])
        for s in stats[1:]:
            assert [s[k] for k in keys] == [stats[0][k] for k in keys]
