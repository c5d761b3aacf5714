"""HF GPT-2 weights in the port (``models/gpt2.load_hf_gpt2``,
``gpt2_train --model_checkpoint DIR`` and ``--finetune``) against the JAX
package's ``load_hf_gpt2``, mirroring ``tests/test_gpt2_pretrained.py``.

A tiny seeded checkpoint (HF's key names and ``Conv1D`` ``(in, out)``
layout, numpy draws) is written as ``pytorch_model.bin`` and as
``model.safetensors`` (by this file's own writer, float32 or BF16). Both
packages load it: every leaf and the flat vectors are equal bit for bit,
``.bin`` and ``.safetensors`` give the same, a BF16 file gives the
bfloat16 values exactly, a directory without weights gives None, and the
resize keeps the loaded rows exactly (its new rows are the port's own
N(0, 0.02) draws: their count and scale are checked). One GPT-2 round
from the loaded (JAX-resized) weights agrees with JAX's within
``tests/test_torch_gpt2_rounds.py``'s tolerances (losses ``rtol=1e-4``,
weights ``rtol=1e-4, atol=1e-6``). Where ``transformers`` imports, the
port's logits on the loaded weights match ``GPT2LMHeadModel``'s on the
same state dict to ``atol=2e-3, rtol=2e-3`` (the JAX test's bound).
``gpt2_train`` runs on the CPU from the HF directory, and ``--finetune``
on the run dir it saved: eval only, a finite val NLL, and the weights it
starts from are the saved ones bit for bit.
"""

import json
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
from commefficient_tpu.federated.losses import (  # noqa: E402
    make_gpt2_losses as j_losses,
)
from commefficient_tpu.models import gpt2 as JG  # noqa: E402
from commefficient_torch import gpt2_train  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    flax_from_port,
    params_from_flax,
)
from commefficient_torch.federated import FedModel, FedOptimizer  # noqa: E402
from commefficient_torch.federated.checkpoint import load_checkpoint  # noqa: E402
from commefficient_torch.federated.losses import (  # noqa: E402
    make_gpt2_losses as t_losses,
)
from commefficient_torch.models import gpt2 as TG  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

VOCAB, POS, EMBD, LAYER, HEAD = 512, 64, 64, 2, 2


def hf_state(seed=0, vocab=VOCAB, pos=POS, embd=EMBD, layer=LAYER):
    """A seeded GPT-2 state dict under HF's names: ``Conv1D`` weights
    ``(in, out)``, the tied ``lm_head.weight``."""
    rs = np.random.RandomState(seed)

    def t(*shape, std=0.02):
        return torch.from_numpy((rs.randn(*shape) * std).astype(np.float32))

    sd = {"transformer.wte.weight": t(vocab, embd),
          "transformer.wpe.weight": t(pos, embd, std=0.01)}
    for i in range(layer):
        p = f"transformer.h.{i}."
        sd[p + "ln_1.weight"] = 1.0 + t(embd, std=0.1)
        sd[p + "ln_1.bias"] = t(embd)
        sd[p + "attn.c_attn.weight"] = t(embd, 3 * embd)
        sd[p + "attn.c_attn.bias"] = t(3 * embd)
        sd[p + "attn.c_proj.weight"] = t(embd, embd)
        sd[p + "attn.c_proj.bias"] = t(embd)
        sd[p + "ln_2.weight"] = 1.0 + t(embd, std=0.1)
        sd[p + "ln_2.bias"] = t(embd)
        sd[p + "mlp.c_fc.weight"] = t(embd, 4 * embd)
        sd[p + "mlp.c_fc.bias"] = t(4 * embd)
        sd[p + "mlp.c_proj.weight"] = t(4 * embd, embd)
        sd[p + "mlp.c_proj.bias"] = t(embd)
    sd["transformer.ln_f.weight"] = 1.0 + t(embd, std=0.1)
    sd["transformer.ln_f.bias"] = t(embd)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def write_safetensors(path, sd, bf16=()):
    """The safetensors layout: an 8-byte little-endian header length, the
    JSON header, the raw bytes; names in ``bf16`` stored as BF16."""
    header, blobs, off = {}, [], 0
    for name, t in sd.items():
        if name in bf16:
            raw = t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()
            dt = "BF16"
        else:
            raw = t.numpy().astype(np.float32).tobytes()
            dt = "F32"
        header[name] = {"dtype": dt, "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for b in blobs:
            f.write(b)


def _jax_template(vocab=VOCAB, pos=POS):
    jm = JG.GPT2DoubleHeads(vocab_size=vocab, n_positions=pos, n_embd=EMBD,
                            n_layer=LAYER, n_head=HEAD, dropout=0.0)
    ids = jnp.zeros((1, 2, 16), jnp.int32)
    params = jm.init(jax.random.key(0), ids, token_type_ids=ids,
                     mc_token_ids=jnp.zeros((1, 2), jnp.int32),
                     train=False)["params"]
    return jm, params


def _port_model(vocab=VOCAB, pos=POS, dropout=0.0):
    return TG.GPT2DoubleHeads(vocab_size=vocab, n_positions=pos,
                              n_embd=EMBD, n_layer=LAYER, n_head=HEAD,
                              dropout=dropout)


def _port_template(jparams, tm):
    layout = ParamLayout(tm)
    flat = flat_from_jax(np.asarray(ravel_pytree(jparams)[0]), layout)
    return flax_from_port(layout.params(flat), layout), layout


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _u32(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    sd = hf_state()
    os.makedirs(d / "bin")
    torch.save(sd, d / "bin" / "pytorch_model.bin")
    os.makedirs(d / "st")
    write_safetensors(d / "st" / "model.safetensors", sd)
    os.makedirs(d / "bf16")
    write_safetensors(d / "bf16" / "model.safetensors", sd,
                      bf16=("transformer.wte.weight",
                            "transformer.h.1.mlp.c_fc.weight"))
    return d, sd


@pytest.mark.parametrize("fmt", ["bin", "st", "bf16"])
def test_load_equals_jax_bit_for_bit(ckpt, fmt):
    d, sd = ckpt
    _, jparams = _jax_template()
    tm = _port_model()
    ttemplate, layout = _port_template(jparams, tm)
    jtree = JG.load_hf_gpt2(jparams, str(d / fmt))
    ttree = TG.load_hf_gpt2(ttemplate, str(d / fmt))
    jl, tl = list(_leaves(jtree)), list(_leaves(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(_u32(b), _u32(a), err_msg=str(p))
    jflat = np.asarray(ravel_pytree(jtree)[0], np.float32)
    tflat = layout.flatten(params_from_flax(ttree, layout)).numpy()
    np.testing.assert_array_equal(_u32(tflat), _u32(jflat))
    # the HF Conv1D (in, out) lands in flax's kernel layout and crosses
    # into nn.Linear's (out, in)
    w = sd["transformer.h.0.attn.c_attn.weight"]
    if fmt == "bf16":
        w = sd["transformer.h.0.attn.c_attn.weight"]  # stored F32 there
    np.testing.assert_array_equal(ttree["h0"]["attn_qkv"]["kernel"],
                                  w.numpy())
    tp = params_from_flax(ttree, layout)
    np.testing.assert_array_equal(tp["h0.attn_qkv.weight"].numpy(),
                                  w.numpy().T)
    if fmt == "bf16":
        want = sd["transformer.wte.weight"].to(torch.bfloat16).float()
        np.testing.assert_array_equal(ttree["wte"]["embedding"],
                                      want.numpy())
    else:
        # mc_head stays the template's
        np.testing.assert_array_equal(
            ttree["mc_head"]["kernel"],
            np.asarray(jparams["mc_head"]["kernel"]))


def test_bin_and_safetensors_agree_and_missing_is_none(ckpt, tmp_path):
    d, _ = ckpt
    _, jparams = _jax_template()
    ttemplate, _ = _port_template(jparams, _port_model())
    a = list(_leaves(TG.load_hf_gpt2(ttemplate, str(d / "bin"))))
    b = list(_leaves(TG.load_hf_gpt2(ttemplate, str(d / "st"))))
    for (p, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(_u32(x), _u32(y), err_msg=str(p))
    assert TG.load_hf_gpt2(ttemplate, str(tmp_path)) is None
    assert JG.load_hf_gpt2(jparams, str(tmp_path)) is None


def test_resize_keeps_the_loaded_rows(ckpt):
    d, sd = ckpt
    _, jparams = _jax_template()
    ttemplate, _ = _port_template(jparams, _port_model())
    tree = TG.load_hf_gpt2(ttemplate, str(d / "st"))
    grown = TG.resize_token_embeddings(tree, VOCAB + 5)
    wte = np.asarray(grown["wte"]["embedding"])
    jgrown = JG.resize_token_embeddings(
        JG.load_hf_gpt2(jparams, str(d / "st")), VOCAB + 5)
    assert wte.shape == np.asarray(jgrown["wte"]["embedding"]).shape \
        == (VOCAB + 5, EMBD)
    np.testing.assert_array_equal(wte[:VOCAB],
                                  sd["transformer.wte.weight"].numpy())
    new = wte[VOCAB:]
    assert 0.005 < new.std() < 0.05 and abs(new.mean()) < 0.01
    assert TG.resize_token_embeddings(tree, VOCAB) is tree


def test_logits_match_transformers(ckpt, monkeypatch):
    # the PyTorch model alone: no TensorFlow import
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    d, sd = ckpt
    cfg = transformers.GPT2Config(vocab_size=VOCAB, n_positions=POS,
                                  n_embd=EMBD, n_layer=LAYER, n_head=HEAD,
                                  resid_pdrop=0.0, embd_pdrop=0.0,
                                  attn_pdrop=0.0)
    hf = transformers.GPT2LMHeadModel(cfg).eval()
    hf.load_state_dict(sd, strict=False)
    _, jparams = _jax_template()
    tm = _port_model()
    ttemplate, layout = _port_template(jparams, tm)
    tree = TG.load_hf_gpt2(ttemplate, str(d / "st"))
    tm.load_state_dict(params_from_flax(tree, layout))
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, VOCAB,
                                                            (2, 16)))
    with torch.no_grad():
        ours, _ = tm(ids)
        ref = hf(ids).logits
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-3,
                               rtol=2e-3)


def _round_batch(W=3, B=2, C=2, T=32):
    rng = np.random.RandomState(60)
    lm = rng.randint(0, VOCAB, (W, B, C, T)).astype(np.int64)
    lm[..., :T // 3] = -1
    return {"input_ids": rng.randint(0, VOCAB, (W, B, C, T)).astype(np.int64),
            "token_type_ids": rng.randint(0, VOCAB, (W, B, C, T))
            .astype(np.int64),
            "lm_labels": lm,
            "mc_token_ids": rng.randint(0, T, (W, B, C)).astype(np.int64),
            "mc_labels": rng.randint(0, C, (W, B)).astype(np.int64),
            "mask": np.ones((W, B), np.float32),
            "client_ids": np.arange(W, dtype=np.int32),
            "worker_mask": np.ones(W, np.float32)}


def test_round_from_loaded_weights_matches_jax(ckpt):
    d, _ = ckpt
    argv = ["--mode", "sketch", "--error_type", "virtual",
            "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--k", "2000", "--num_cols", "20000", "--num_rows", "5",
            "--num_blocks", "20", "--num_workers", "3", "--num_devices",
            "1", "--num_clients", "6", "--dataset_name", "PERSONA",
            "--local_batch_size", "2", "--max_seq_len", "32", "--seed", "0"]
    jm, jparams = _jax_template(vocab=VOCAB + 5)
    # the JAX-resized table crosses over: the resize's new rows are each
    # package's own draws
    jtree = JG.resize_token_embeddings(
        JG.load_hf_gpt2(_jax_template()[1], str(d / "bin")), VOCAB + 5)
    jargs = j_parse(argv=argv + ["--no_telemetry"])
    jtrain, jval = j_losses(jm)
    jfm = JFedModel(jm, jtrain, jargs, jval, num_clients=6,
                    init_params=jtree)
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(0.05)
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])
    tm = _port_model(vocab=VOCAB + 5)
    targs = t_parse(argv=argv + ["--device", "cpu"])
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=6,
                   init_params=flat_from_jax(flat0, ParamLayout(tm)),
                   device="cpu")
    topt = FedOptimizer(tfm, targs)
    topt.set_lr_factor(0.05)
    b = _round_batch()
    jres, tres = jfm(b), tfm(b)
    jopt.step()
    topt.step()
    np.testing.assert_allclose(tres[0], jres[0], rtol=1e-4)
    tw = tfm.layout.unchunk(tfm.ps_weights).numpy()
    np.testing.assert_allclose(tw, np.asarray(ravel_pytree(jfm.params)[0]),
                               rtol=1e-4, atol=1e-6)


TRAIN = ["--device", "cpu", "--num_epochs", "1", "--num_workers", "2",
         "--local_batch_size", "2", "--max_seq_len", "32",
         "--mode", "sketch", "--error_type", "virtual",
         "--local_momentum", "0", "--virtual_momentum", "0.9",
         "--k", "5000", "--num_cols", "20000", "--num_rows", "3",
         "--num_blocks", "2", "--seed", "0"]


def test_gpt2_train_from_hf_and_finetune(tmp_path, monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_TINY_MODEL", "1")
    monkeypatch.setenv("COMMEFFICIENT_SYNTHETIC_CLIENTS", "8")
    hf_dir = tmp_path / "hf"
    os.makedirs(hf_dir)
    # the tiny model: vocab max(512, len(tokenizer)), 32 positions
    write_safetensors(hf_dir / "model.safetensors",
                      hf_state(seed=4, vocab=512, pos=32))
    data = ["--dataset_dir", str(tmp_path / "data")]
    args = t_parse(argv=TRAIN + data + ["--model_checkpoint", str(hf_dir)])
    model = gpt2_train.build_model(args, 262)
    flat, what = gpt2_train.initial_weights(args, model, 262)
    assert what == "local pretrained GPT-2 weights"
    layout = ParamLayout(model)
    wte = layout.params(flat)["wte.embedding"].numpy()
    np.testing.assert_array_equal(
        wte, hf_state(seed=4, vocab=512, pos=32)[
            "transformer.wte.weight"].numpy())

    monkeypatch.setenv("COMMEFFICIENT_RUN_DIR", str(tmp_path / "run"))
    stats = gpt2_train.train(TRAIN + data + ["--model_checkpoint",
                                             str(hf_dir)])
    assert np.isfinite(stats["val_nll"])
    saved, _ = load_checkpoint(str(tmp_path / "run" / "model"))

    monkeypatch.setenv("COMMEFFICIENT_RUN_DIR", str(tmp_path / "ft"))
    ft = TRAIN + data + ["--finetune", "--finetune_path",
                         str(tmp_path / "run")]
    stats = gpt2_train.train(ft)
    assert np.isfinite(stats["val_nll"]) and "val_ppl" in stats
    # eval only: no weights written
    assert not os.path.exists(tmp_path / "ft" / "model.npz")
    fargs = t_parse(argv=ft)
    fargs.model_checkpoint = fargs.finetune_path
    fmodel = gpt2_train.build_model(fargs, 262)
    fflat, what = gpt2_train.initial_weights(fargs, fmodel, 262)
    assert what.startswith("saved run dir: ")
    flayout = ParamLayout(fmodel)
    want = flayout.flatten(params_from_flax(saved, flayout)).numpy()
    np.testing.assert_array_equal(_u32(fflat.numpy()), _u32(want))
