"""The port's learning-evidence scripts (``commefficient_torch/scripts/``
``sketch_fidelity``, ``learning_fullscale``, ``learning_midscale``,
``learning_async``, ``femnist_ablation``, ``gpt2_golden_calibrate``) and
their harness ``utils.run_cv_recorded`` against the JAX package's
``scripts/`` of the same names, on the CPU.

- ``chunked_cyclic`` at d = 200,000, a 5 x 16,384 sketch and k = 2,000 on
  a seeded power-law vector: the port's kept set equals the JAX script's
  bit for bit and the kept values agree to ``VALUES_RTOL``;
  ``powerlaw_vector``, ``ideal_count_sketch`` and ``metrics`` give the
  JAX script's numbers exactly (the same numpy code).
- The recipes: each leg's argv equals the ``argv`` committed in
  ``docs/learning_midscale.json`` and ``docs/learning_async.json`` and
  the JAX scripts' own lists, read in a subprocess (those scripts set
  environment variables and pin JAX's CPU mesh at import). The one flag
  that exists for that mesh, ``--num_devices`` (8 there, 1 in the port),
  and the port's trailing ``--device`` are the only differences.
- The harness: a one-epoch ``LEARN_TINY=1`` run of ``learning_fullscale``
  through ``run_cv_recorded`` returns rows with the JAX rows' keys, and
  the real ``TableLogger`` comes back on every exit path.
- The guard: without a card every script refuses to start unless the
  CPU is asked for (``learning_fullscale`` also needs
  ``COMMEFFICIENT_LEARNING_ALLOW_CPU=1``).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_torch import utils as tutils  # noqa: E402
from commefficient_torch.scripts import (  # noqa: E402
    femnist_ablation,
    gpt2_golden_calibrate,
    learning_async,
    learning_fullscale,
    learning_midscale,
    sketch_fidelity,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kept values: the same float32 table and median network on both
# sides; the tolerance covers a summation-order difference only
VALUES_RTOL = 1e-6
# the flags that exist for the JAX scripts' 8-device CPU mesh, with the
# port's value
CPU_MESH_FLAGS = {"--num_devices": ("8", "1")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread while this module runs
    (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_fidelity():
    spec = importlib.util.spec_from_file_location(
        "jax_sketch_fidelity", os.path.join(ROOT, "scripts",
                                            "sketch_fidelity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- sketch_fidelity -------------------------------------------------------

D, R, C, K = 200_000, 5, 16_384, 2_000


@pytest.mark.parametrize("trial", (0, 1))
def test_chunked_cyclic_kept_set_as_jax(jax_fidelity, trial):
    rng = np.random.RandomState(100 + trial)
    v = sketch_fidelity.powerlaw_vector(rng, D)
    want = jax_fidelity.chunked_cyclic(v, R, C, K, seed=200 + trial)
    got = sketch_fidelity.chunked_cyclic(v, R, C, K, seed=200 + trial,
                                         device="cpu")
    assert got.dtype == want.dtype == np.float32 and got.shape == (D,)
    kept = np.flatnonzero(got)
    assert kept.size == K
    np.testing.assert_array_equal(kept, np.flatnonzero(want))
    np.testing.assert_allclose(got[kept], want[kept], rtol=VALUES_RTOL,
                               atol=0)
    assert sketch_fidelity.metrics(v, got, K) == pytest.approx(
        jax_fidelity.metrics(v, want, K), rel=1e-6)


def test_numpy_families_and_metrics_as_jax(jax_fidelity):
    v_t = sketch_fidelity.powerlaw_vector(np.random.RandomState(100), D)
    v_j = jax_fidelity.powerlaw_vector(np.random.RandomState(100), D)
    np.testing.assert_array_equal(v_t, v_j)
    got = sketch_fidelity.ideal_count_sketch(np.random.RandomState(7), v_t,
                                             R, C, K)
    want = jax_fidelity.ideal_count_sketch(np.random.RandomState(7), v_j,
                                           R, C, K)
    np.testing.assert_array_equal(got, want)
    assert sketch_fidelity.metrics(v_t, got, K) == jax_fidelity.metrics(
        v_j, want, K)


def test_sketch_fidelity_main_on_cpu(tmp_path):
    """The script end to end on the CPU at a small d: its JSON holds
    both families' rows and means and where it ran."""
    out = str(tmp_path / "sf.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sketch_fidelity, "D", D)
        mp.setattr(sketch_fidelity, "C", C)
        mp.setattr(sketch_fidelity, "K", K)
        assert sketch_fidelity.main(["--device", "cpu", "--trials", "1",
                                     "--out", out]) == 0
    rec = json.load(open(out))
    assert rec["backend"] == "cpu" and rec["geometry"]["d"] == D
    assert [r["family"] for r in rec["rows"]] == list(
        sketch_fidelity.FAMILIES)
    assert rec["means"]["chunked-cyclic"]["recall_mass"] > 0.99


# ---- the recipes -----------------------------------------------------------

_JAX_RECIPES = r"""
import json, os, sys
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)
for k in ("LEARN_TINY", "LEARN_EPOCHS", "LEARN_PIVOT", "FEMNIST_SAMPLES",
          "FEMNIST_EPOCHS", "FEMNIST_SKETCH_LR"):
    os.environ.pop(k, None)
out = {}
import learning_fullscale as lf
out["fullscale"] = {"sketch": lf.COMMON + lf.SKETCH,
                    "uncompressed": lf.COMMON + lf.UNCOMPRESSED}
import learning_midscale as lm
out["midscale"] = {leg: lm.common(*spec[:5]) + spec[5] + spec[6]
                   for leg, spec in lm.LEGS.items()}
import learning_async as la
out["async"] = {leg: la.common(ep, seed) + la.SKETCH + extra
                for leg, (ep, seed, extra) in la.LEGS.items()}
import commefficient_tpu.utils as ju
import femnist_ablation as fa
got = []
ju.run_cv_recorded = lambda argv, tag: got.append(argv) or []
for s in fa.SAMPLE_GRID:
    for tag, mode in (("sketch", fa.SKETCH),
                      ("uncompressed", fa.UNCOMPRESSED)):
        fa.run(tag, s, mode)
        out.setdefault("femnist", {})[f"{tag}_s{s}"] = got[-1]
print("RECIPES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_recipes():
    env = {k: v for k, v in os.environ.items()
           if k not in ("COMMEFFICIENT_TINY_MODEL",
                        "COMMEFFICIENT_SYNTHETIC_PER_CLASS",
                        "COMMEFFICIENT_SYNTHETIC_CLIENTS")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _JAX_RECIPES],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RECIPES "))
    return json.loads(line[len("RECIPES "):])


def _as_jax(argv, root=ROOT):
    """The port's argv in the JAX scripts' form: the CPU-mesh flags at
    JAX's values and the dataset path relative to the repo."""
    out = list(argv)
    for flag, (jax_value, port_value) in CPU_MESH_FLAGS.items():
        if flag in out:
            i = out.index(flag)
            assert out[i + 1] == port_value
            out[i + 1] = jax_value
    return _rel_dataset(out, root)


def _rel_dataset(argv, root):
    out = list(argv)
    i = out.index("--dataset_dir")
    out[i + 1] = os.path.relpath(out[i + 1], root)
    return out


def test_fullscale_recipe_as_jax(jax_recipes, monkeypatch):
    for k in ("LEARN_TINY", "LEARN_EPOCHS", "LEARN_PIVOT"):
        monkeypatch.delenv(k, raising=False)
    legs = learning_fullscale.legs()
    assert {k: _as_jax(v) for k, v in legs.items()} == {
        k: _rel_dataset(v, ROOT)
        for k, v in jax_recipes["fullscale"].items()}
    assert not any(f in argv for argv in legs.values()
                   for f in CPU_MESH_FLAGS)


@pytest.mark.parametrize("script,doc", ((learning_midscale, "midscale"),
                                        (learning_async, "async")))
def test_rung_recipes_as_jax(jax_recipes, script, doc):
    want = jax_recipes[doc]
    assert set(script.LEGS) == set(want)
    for leg in script.LEGS:
        assert _as_jax(script.leg_argv(leg)) == _rel_dataset(want[leg], ROOT)
    # the legs the JAX package ran and committed, argv and channels
    with open(os.path.join(ROOT, "docs", f"learning_{doc}.json")) as f:
        committed = json.load(f)
    for leg, rec in committed.items():
        # recorded on the host that ran them: its repo root is the
        # recorded dataset path's grandparent
        recorded_root = rec["argv"][rec["argv"].index("--dataset_dir") + 1]
        recorded_root = os.path.dirname(os.path.dirname(recorded_root))
        assert _as_jax(script.leg_argv(leg)) == _rel_dataset(rec["argv"],
                                                             recorded_root)
        channels = (script.LEGS[leg][0] if script is learning_midscale
                    else learning_async.GOLDEN_CHANNELS)
        assert channels == rec["channels"]


def test_femnist_recipe_as_jax(jax_recipes, monkeypatch):
    for k in ("FEMNIST_SAMPLES", "FEMNIST_EPOCHS", "FEMNIST_SKETCH_LR"):
        monkeypatch.delenv(k, raising=False)
    got = {}
    for s in femnist_ablation.sample_grid():
        for tag, mode in (("sketch", femnist_ablation.sketch()),
                          ("uncompressed", femnist_ablation.UNCOMPRESSED)):
            got[f"{tag}_s{s}"] = _as_jax(femnist_ablation.run_argv(s, mode))
    assert got == {k: _rel_dataset(v, ROOT)
                   for k, v in jax_recipes["femnist"].items()}


def test_gpt2_recipe_as_jax_test():
    """The calibration recipe is the one ``tests/test_gpt2.py``'s
    ``TestGoldenTrajectory`` pins (and the JAX script runs)."""
    with open(os.path.join(ROOT, "tests", "test_gpt2.py")) as f:
        src = f.read()
    block = src[src.index("def test_sketched_lm_envelope"):]
    block = block[block.index("argv=["):block.index("])")]
    argv = gpt2_golden_calibrate.run_argv(3, "DATA")
    flags = [a for a in argv if a.startswith("--")]
    for flag, value in zip(argv, argv[1:]):
        if flag.startswith("--") and not value.startswith("--") \
                and flag != "--dataset_dir":
            assert f'"{flag}", "{value}"' in block, flag
    assert all(f'"{f}"' in block for f in flags)


# ---- the harness and the guard ---------------------------------------------

def test_run_cv_recorded_rows_have_jax_keys(tmp_path, monkeypatch):
    with open(os.path.join(ROOT, "docs", "learning_fullscale.json")) as f:
        jax_keys = list(json.load(f)["sketch"][0])
    for k, v in (("LEARN_TINY", "1"), ("LEARN_EPOCHS", "1"),
                 ("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "16"),
                 ("COMMEFFICIENT_LEARNING_ALLOW_CPU", "1"),
                 ("COMMEFFICIENT_TINY_MODEL", "")):
        monkeypatch.setenv(k, v)
    out = str(tmp_path / "lf.json")
    assert learning_fullscale.main([
        "--device", "cpu", "--out", out, "--data_root", str(tmp_path),
        "--run_root", str(tmp_path / "runs")]) == 0
    rec = json.load(open(out))
    assert (rec["epochs"], rec["tiny"], rec["backend"]) == ("1", True, "cpu")
    for tag in ("sketch", "uncompressed"):
        assert len(rec[tag]) == 1 and list(rec[tag][0]) == jax_keys
        assert all(isinstance(v, (int, float)) for v in rec[tag][0].values())
        assert (tmp_path / "runs" / tag / "telemetry.jsonl").is_file()
    # a second call keeps both legs
    assert learning_fullscale.main([
        "--device", "cpu", "--out", out, "--data_root", str(tmp_path)]) == 0
    assert json.load(open(out)) == rec


def test_run_cv_recorded_restores_the_logger(monkeypatch):
    from commefficient_torch import cv_train

    def boom(argv):
        cv_train.TableLogger().append({"epoch": 1, "lr": np.float64(0.5)})
        raise RuntimeError("boom")

    monkeypatch.setattr(cv_train, "main", boom)
    seen = []
    with pytest.raises(RuntimeError, match="boom"):
        tutils.run_cv_recorded([], "t", echo=seen.append)
    assert cv_train.TableLogger is tutils.TableLogger
    assert seen == ["[t] {'epoch': 1, 'lr': 0.5}"]


SCRIPTS = (sketch_fidelity, learning_fullscale, learning_midscale,
           learning_async, femnist_ablation, gpt2_golden_calibrate)


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda m: m.__name__.rsplit(
    ".", 1)[-1])
def test_scripts_refuse_without_a_card(script, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("COMMEFFICIENT_LEARNING_ALLOW_CPU", raising=False)
    out = str(tmp_path / "x.json")
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        script.main(["--out", out])
    if script is learning_fullscale:
        with pytest.raises(SystemExit, match="ALLOW_CPU=1"):
            script.main(["--device", "cpu", "--out", out])
    assert not os.path.exists(out)
