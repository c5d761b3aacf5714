"""The port's GPT-2 workload against the JAX package on the CPU: the
tokenizer, the PersonaChat data, the flat parameter layout, the
double-heads model and its losses.

The same seeded numpy inputs go to both packages; the JAX side runs as its
own tests run it (on the CPU, one device). The model is a tiny GPT-2
(n_embd 64, 2 heads, vocab 512, 32 tokens) with dropout 0, except where
the port's own dropout is tested.

Tolerances: token ids, data items, collated batches, layout and the flat
vector are exact. The forward sums in another order than XLA (einsum and
matmul blocking, ``F.layer_norm`` against flax's fast variance), so LM and
MC logits agree to ``rtol=1e-5, atol=2e-6``, losses to ``rtol=1e-5``, and
the flat gradient of the summed train loss to ``rtol=1e-4, atol=1e-6``.
Under ``--bf16`` both packages round activations to bfloat16 at
different places (torch's softmax and LayerNorm accumulate in float32
internally), so the losses agree to ``rtol=1e-3`` and the gradient to a
relative L2 error below 2e-2 (1.0e-2 measured). That is as far from
JAX's bf16 gradient as the float32 one is (7.6e-3 measured), so the
bf16 test also pins that every matrix product of the port's forward
takes bfloat16 and that its gradient moves from the float32 one.
"""

import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.data_utils import fed_persona as jfp  # noqa: E402
from commefficient_tpu.data_utils import tokenization as jtok  # noqa: E402
from commefficient_tpu.data_utils.loader import FedLoader as JLoader  # noqa: E402
from commefficient_tpu.federated.losses import (  # noqa: E402
    make_gpt2_losses as j_losses,
)
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JGPT2  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    flax_from_port,
    params_from_flax,
)
from commefficient_torch.data_utils import fed_persona as tfp  # noqa: E402
from commefficient_torch.data_utils import tokenization as ttok  # noqa: E402
from commefficient_torch.data_utils.loader import FedLoader as TLoader  # noqa: E402
from commefficient_torch.federated.losses import (  # noqa: E402
    make_gpt2_losses as t_losses,
)
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.models.gpt2 import (  # noqa: E402
    GeneratorKeep,
    GPT2DoubleHeads,
    MaskKeep,
    resize_token_embeddings,
)
from commefficient_torch.ops.flat import (  # noqa: E402
    ParamLayout,
    jax_to_torch_layout,
)

TINY = dict(vocab_size=512, n_positions=64, n_embd=64, n_layer=2, n_head=2)
NB, NC, T = 2, 2, 32


@pytest.fixture(autouse=True)
def synthetic_clients(monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")


def _tokenizers():
    j = jtok.get_tokenizer()
    t = ttok.get_tokenizer()
    j.add_special_tokens(jtok.ATTR_TO_SPECIAL_TOKEN)
    t.add_special_tokens(ttok.ATTR_TO_SPECIAL_TOKEN)
    return j, t


def _corpus():
    raw = jfp._synthetic_personachat()
    texts = []
    for split in raw.values():
        for dialog in split:
            texts.extend(dialog["personality"])
            for utt in dialog["utterances"]:
                texts.extend(utt["history"])
                texts.extend(utt["candidates"])
    return texts


# -- tokenizer -------------------------------------------------------------

def test_tokenizer_ids_equal_jax():
    j, t = _tokenizers()
    assert type(j).__name__ == "GPT2Tokenizer"  # HF over the vendored BPE
    assert isinstance(t, ttok.BPETokenizer)
    assert len(j) == len(t) == 262
    specials = ["<bos>", "<eos>", "<pad>", "<speaker1>", "<speaker2>",
                "<|endoftext|>"]
    assert t.convert_tokens_to_ids(specials) == \
        j.convert_tokens_to_ids(specials) == [257, 258, 259, 260, 261, 256]
    texts = _corpus() + [
        "héllo ☃ 2² it's I'll  \t\n x_y", "x<bos>y <eos> z",
        "<speaker1>hi<speaker2> there<|endoftext|>", "", "  "]
    for s in texts:
        assert t.tokenize(s) == j.tokenize(s), s
        assert t.convert_tokens_to_ids(t.tokenize(s)) == \
            j.convert_tokens_to_ids(j.tokenize(s)), s


def test_tokenizer_save_pretrained_reads_back_in_jax(tmp_path):
    j, t = _tokenizers()
    t.save_pretrained(str(tmp_path))
    back = jtok.get_tokenizer(str(tmp_path))
    assert len(back) == 262
    again = ttok.get_tokenizer(str(tmp_path))
    assert len(again) == 262
    for s in _corpus()[:40] + ["<speaker2>a b<eos>"]:
        ids = t.encode(s)
        assert back.convert_tokens_to_ids(back.tokenize(s)) == ids
        assert again.encode(s) == ids
    with open(tmp_path / "added_tokens.json") as f:
        assert json.load(f)["<speaker2>"] == 261


def test_tokenizer_falls_back_to_bytes(tmp_path, monkeypatch):
    """A run dir saved by a ByteTokenizer round keeps it; without the
    vendored files the last resort is ByteTokenizer, whose ids equal the
    JAX package's."""
    b = ttok.ByteTokenizer()
    b.add_special_tokens(ttok.ATTR_TO_SPECIAL_TOKEN)
    b.save_pretrained(str(tmp_path))
    got = ttok.get_tokenizer(str(tmp_path))
    assert isinstance(got, ttok.ByteTokenizer) and len(got) == 261
    monkeypatch.setattr(ttok, "VENDORED_BPE_DIR", str(tmp_path / "none"))
    last = ttok.get_tokenizer("gpt2")
    jb = jtok.ByteTokenizer()
    assert isinstance(last, ttok.ByteTokenizer)
    assert last.encode("hé <bos>") == jb.encode("hé <bos>")


# -- data ------------------------------------------------------------------

def _datasets(tmp_path, tok_j, tok_t, train, num_candidates=2):
    out = []
    for mod, tok, sub in ((jfp, tok_j, "j"), (tfp, tok_t, "t")):
        np.random.seed(0)
        random.seed(0)
        out.append(mod.FedPERSONA(
            tok, num_candidates, 2, 1, str(tmp_path / sub), "PERSONA", None,
            False, None, train=train, download=train, max_seq_len=T))
    return out


def test_fed_persona_items_partition_and_sentinel(tmp_path):
    j, t = _tokenizers()
    jd, td = _datasets(tmp_path, j, t, True)
    assert td.num_clients == jd.num_clients == 8
    np.testing.assert_array_equal(td.data_per_client, jd.data_per_client)
    assert len(td) == len(jd)
    random.seed(1)
    jitems = [jd[i] for i in range(len(jd))]
    random.seed(1)
    titems = [td[i] for i in range(len(td))]
    assert titems == jitems
    jv, tv = _datasets(tmp_path, j, t, False, num_candidates=-1)
    assert len(tv) == len(jv)
    assert [tv[i] for i in range(len(tv))] == [jv[i] for i in range(len(jv))]
    assert tv[0][0] == -1


def test_collated_batches_equal(tmp_path):
    j, t = _tokenizers()
    jd, td = _datasets(tmp_path, j, t, True)
    jv, tv = _datasets(tmp_path, j, t, False, num_candidates=-1)
    loaders = []
    for L, mod, ds, vs in ((JLoader, jfp, jd, jv), (TLoader, tfp, td, tv)):
        np.random.seed(3)
        random.seed(3)
        train = L(ds, 2, 2, collate_fn=mod.make_personachat_collate_fn(T, 2))
        val = L(vs, val_batch_size=4,
                collate_fn=mod.make_personachat_collate_fn(T, 3))
        loaders.append((list(train), list(val)))
    (jt, jv_), (tt, tv_) = loaders
    assert len(tt) == len(jt) > 0 and len(tv_) == len(jv_) > 0
    for a, b in zip(jt + jv_, tt + tv_):
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert tt[0]["input_ids"].shape == (2, 2, 2, T)


def test_collate_left_truncates():
    items = [([list(range(50)), list(range(40))], [49, 39],
              [[-1] * 45 + [1, 2, 3, 4, 5], [-1] * 40], 1,
              [[7] * 50, [8] * 40])]
    got = tfp.make_personachat_collate_fn(T, 2)(items)
    want = jfp.make_personachat_collate_fn(T, 2)(items)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["mc_token_ids"][0, 0] == T - 1
    assert list(got["lm_labels"][0, 0, -5:]) == [1, 2, 3, 4, 5]


# -- layout ----------------------------------------------------------------

def _jax_model(cfg=TINY, dropout=0.0):
    jm = JGPT2(**cfg, dropout=dropout)
    ids = jnp.zeros((1, NC, T), jnp.int32)
    params = jm.init(jax.random.key(0), ids, token_type_ids=ids,
                     mc_token_ids=jnp.zeros((1, NC), jnp.int32),
                     train=False)["params"]
    return jm, params


def _jax_paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(k.key for k in path), tuple(np.shape(x)))
            for path, x in leaves]


def test_layout_equals_ravel_pytree_and_round_trips():
    cfg = dict(vocab_size=300, n_positions=16, n_embd=16, n_layer=12,
               n_head=2)
    jm, params = _jax_model(cfg)
    flat = np.asarray(ravel_pytree(params)[0])
    tm = GPT2DoubleHeads(**cfg, dropout=0.0)
    layout = ParamLayout(tm)
    assert layout.d == flat.size
    assert [(e.jax_path, e.jax_shape) for e in layout.entries] == \
        _jax_paths(params)
    names = [e.jax_path[0] for e in layout.entries]
    assert names.index("h10") < names.index("h2")  # sorted as strings
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    tparams = params_from_flax(np_tree, layout)
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(), flat)
    w = flat_from_jax(flat, layout)
    back = flax_from_port(layout.params(w), layout)
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(np_tree)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_embedding_leaves_keep_their_layout():
    """flax and ``nn.Embedding`` both store a table ``(num, features)``:
    the port's view of ``wte``/``wpe`` is the flax array itself. A
    transform chosen by rank (every 2-D leaf transposed as a dense
    kernel) gives ``(features, num)`` here and fails."""
    _, params = _jax_model()
    flat = np.asarray(ravel_pytree(params)[0])
    tm = GPT2DoubleHeads(**TINY, dropout=0.0)
    layout = ParamLayout(tm)
    kinds = {e.torch_name: e.kind for e in layout.entries}
    assert kinds["wte.embedding"] == kinds["wpe.embedding"] == "asis"
    assert kinds["h0.attn_qkv.weight"] == "dense"
    assert kinds["h0.ln_1.scale"] == "asis"
    views = layout.params(flat_from_jax(flat, layout))
    for name, key in (("wte.embedding", "wte"), ("wpe.embedding", "wpe")):
        want = np.asarray(params[key]["embedding"])
        assert tuple(views[name].shape) == want.shape
        np.testing.assert_array_equal(views[name].numpy(), want)
        assert views[name].shape == tm.get_parameter(name).shape
    # the dense kernel is transposed into nn.Linear's (out, in)
    np.testing.assert_array_equal(
        views["h0.attn_qkv.weight"].numpy(),
        np.asarray(params["h0"]["attn_qkv"]["kernel"]).T)
    with pytest.raises(ValueError, match="leaf kind"):
        jax_to_torch_layout(torch.zeros(2, 2), "embedding")


def test_resnet9_layout_and_flat_vector_unchanged():
    """The leaf kinds leave ResNet9's flat vector as it was: conv kernels
    HWIO, the linear kernel (in, out), in ravel order, at d = 6,568,640,
    equal to ravel_pytree of the flax model bit for bit."""
    jm = JResNet9()
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = np.asarray(ravel_pytree(params)[0])
    layout = ParamLayout(ResNet9())
    assert layout.d == flat.size == 6_568_640
    assert [(e.jax_path, e.jax_shape) for e in layout.entries] == \
        _jax_paths(params)
    assert [(e.torch_name, e.offset, e.kind) for e in layout.entries] == [
        ("layer1.conv.weight", 0, "conv"),
        ("layer2.conv.weight", 73_728, "conv"),
        ("layer3.conv.weight", 368_640, "conv"),
        ("linear.weight", 1_548_288, "dense"),
        ("prep.conv.weight", 1_553_408, "conv"),
        ("res1.res1.conv.weight", 1_555_136, "conv"),
        ("res1.res2.conv.weight", 1_702_592, "conv"),
        ("res3.res1.conv.weight", 1_850_048, "conv"),
        ("res3.res2.conv.weight", 4_209_344, "conv")]
    tparams = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                               layout)
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(), flat)


# -- model -----------------------------------------------------------------

def _inputs(seed, vocab=TINY["vocab_size"], nb=NB):
    rng = np.random.RandomState(seed)
    lm = rng.randint(0, vocab, (nb, NC, T))
    lm[:, :, :T // 2] = -1
    lm[0, 0] = -1  # an example-candidate with no label
    return {"input_ids": rng.randint(0, vocab, (nb, NC, T)),
            "token_type_ids": rng.randint(0, vocab, (nb, NC, T)),
            "mc_token_ids": rng.randint(0, T, (nb, NC)),
            "lm_labels": lm,
            "mc_labels": rng.randint(0, NC, (nb,)),
            "mask": np.array([1.0] * (nb - 1) + [0.0], np.float32)}


def _pair(dropout=0.0):
    jm, params = _jax_model()
    flat = np.asarray(ravel_pytree(params)[0])
    tm = GPT2DoubleHeads(**TINY, dropout=dropout)
    layout = ParamLayout(tm)
    return jm, params, flat, tm, layout


def test_logits_match_jax():
    jm, params, flat, tm, layout = _pair()
    b = _inputs(0)
    jlm, jmc = jm.apply({"params": params}, jnp.asarray(b["input_ids"]),
                        token_type_ids=jnp.asarray(b["token_type_ids"]),
                        mc_token_ids=jnp.asarray(b["mc_token_ids"]),
                        train=False)
    with torch.no_grad():
        tlm, tmc = torch.func.functional_call(
            tm, layout.params(flat_from_jax(flat, layout)),
            (torch.as_tensor(b["input_ids"]),),
            {"token_type_ids": torch.as_tensor(b["token_type_ids"]),
             "mc_token_ids": torch.as_tensor(b["mc_token_ids"])})
    assert tlm.shape == (NB, NC, T, TINY["vocab_size"])
    assert tmc.shape == (NB, NC)
    np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(tmc.numpy(), np.asarray(jmc), rtol=1e-5,
                               atol=2e-6)


def test_causal_and_tied_head():
    """A later token changes no earlier logit, and the LM head is ``wte``
    itself (``x @ wte.T``)."""
    tm = GPT2DoubleHeads(**TINY, dropout=0.0)
    tm.init_(torch.Generator().manual_seed(0))
    ids = torch.as_tensor(np.random.RandomState(1).randint(0, 512, (1, T)))
    ids2 = ids.clone()
    ids2[0, -1] = (ids2[0, -1] + 1) % 512
    with torch.no_grad():
        a, _ = tm(ids)
        b, _ = tm(ids2)
        torch.testing.assert_close(a[0, :-1], b[0, :-1], rtol=0, atol=0)
        tm.wte.embedding.mul_(2.0)
        c, _ = tm(ids)
        assert not torch.allclose(a, c)


def test_resize_token_embeddings():
    _, params = _jax_model()
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    out = resize_token_embeddings(np_tree, 520)
    wte = out["wte"]["embedding"]
    assert tuple(wte.shape) == (520, TINY["n_embd"])
    np.testing.assert_array_equal(wte[:512].numpy(),
                                  np_tree["wte"]["embedding"])
    assert resize_token_embeddings(np_tree, 100) is np_tree


def test_dropout_keep_rate_and_seed():
    """The port's own dropout: a keep rate of 1 - p, the same masks from
    the same seed, other masks from another, and a pre-drawn flat mask
    consumed exactly (``dropout_numel``)."""
    gen = torch.Generator().manual_seed(5)
    m1 = GeneratorKeep(gen, 0.9)((400, 500), "cpu")
    gen.manual_seed(5)
    m2 = GeneratorKeep(gen, 0.9)((400, 500), "cpu")
    assert torch.equal(m1, m2)
    assert abs(m1.float().mean().item() - 0.9) < 0.005
    m3 = GeneratorKeep(torch.Generator().manual_seed(6), 0.9)((400, 500),
                                                              "cpu")
    assert not torch.equal(m1, m3)

    tm = GPT2DoubleHeads(**TINY, dropout=0.1)
    tm.init_(torch.Generator().manual_seed(0))
    ids = torch.as_tensor(_inputs(0)["input_ids"])
    n = tm.dropout_numel(NB * NC, T)
    flat = torch.rand(n, generator=torch.Generator().manual_seed(1)) < 0.9
    keep = MaskKeep(flat)
    with torch.no_grad():
        a, _ = tm(ids, dropout=keep)
        keep.check_consumed()
        b, _ = tm(ids, dropout=MaskKeep(flat))
        c, _ = tm(ids)
        d, _ = tm(ids, dropout=MaskKeep(torch.ones(n, dtype=torch.bool)))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    # all kept: every value scaled by 1 / 0.9 where flax's would be
    assert not torch.allclose(c, d)
    with pytest.raises(ValueError, match="exhausted"):
        tm(ids, dropout=MaskKeep(flat[:-1]))


# -- losses ----------------------------------------------------------------

def _losses_both(compute_dtype=None):
    jm, params, flat, tm, layout = _pair()
    jtrain, jval = j_losses(jm, compute_dtype=(
        jnp.bfloat16 if compute_dtype is not None else None))
    ttrain, tval = t_losses(tm, compute_dtype=compute_dtype)
    b = _inputs(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    key = jax.random.key(0)

    def jloss(p):
        return jtrain(p, {}, jb, key, True)[0]

    jl, jg = jax.value_and_grad(jloss)(params)
    jv = jval(params, {}, jb, None, False)
    w = flat_from_jax(flat, layout).requires_grad_(True)
    tl, tms, tcount, _ = ttrain(layout.params(w), {}, tb, None, True)
    (tg,) = torch.autograd.grad(tl, w)
    with torch.no_grad():
        tv = tval(layout.params(w), {}, tb, None, False)
    return (jl, np.asarray(ravel_pytree(jg)[0]), jv), (tl, tg, tms, tcount,
                                                       tv)


def test_losses_and_gradient_match_jax():
    (jl, jg, jv), (tl, tg, tms, tcount, tv) = _losses_both()
    assert tms == () and float(tcount) == NB - 1  # no train metrics
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-6)
    (jnll, (jacc,), jcount, _), (tnll, (tacc,), tcount2, _) = jv, tv
    np.testing.assert_allclose(float(tnll), float(jnll), rtol=1e-5)
    assert float(tacc) == float(jacc)
    assert float(tcount2) == float(jcount)


def _matmul_input_dtypes(fn):
    """The set of input dtypes of every matrix product ``fn()`` runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    products = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in products:
                seen.append(frozenset(a.dtype for a in args
                                      if isinstance(a, torch.Tensor)))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def test_losses_bf16_match_jax():
    (jl, jg, jv), (tl, tg, _, _, tv) = _losses_both(torch.bfloat16)
    assert tg.dtype == torch.float32  # the gradient comes back in f32
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-3)
    rel = np.linalg.norm(tg.numpy() - jg) / np.linalg.norm(jg)
    assert rel < 2e-2, rel
    np.testing.assert_allclose(float(tv[0]), float(jv[0]), rtol=1e-3)
    # bf16 ran: the gradient is not the port's float32 one
    _, (_, fg, _, _, _) = _losses_both()
    moved = np.linalg.norm(tg.numpy() - fg.numpy()) / np.linalg.norm(
        fg.numpy())
    assert moved > 2e-3, moved


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_forward_matmuls_take_compute_dtype(bf16):
    """Every matrix product of the train and val forwards (the packed qkv,
    attention, MLP, the tied LM head and the MC head) takes bfloat16
    under ``--bf16`` and float32 without."""
    _, _, flat, tm, layout = _pair()
    want = torch.bfloat16 if bf16 else torch.float32
    ttrain, tval = t_losses(tm, compute_dtype=want if bf16 else None)
    tb = {k: torch.as_tensor(v) for k, v in _inputs(2).items()}
    w = flat_from_jax(flat, layout)
    for loss, train in ((ttrain, True), (tval, False)):
        with torch.no_grad():
            seen = _matmul_input_dtypes(
                lambda: loss(layout.params(w), {}, tb, None, train))
        # 2 layers x (qkv, q k^T, att v, attn_proj, mlp_fc, mlp_proj),
        # the LM head and the MC head
        assert len(seen) == 2 * 6 + 2, len(seen)
        assert all(d == {want} for d in seen), seen