"""The result line's keys, the JAX guard, and the refusals: no card, and
a checkout that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from fedbench import harness, run, spec
from fedbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("root"))


def test_result_keys_in_order_with_checks_last(root):
    out = harness.run(spec.cell("t-resnet9", root), 3, 0.3, False,
                      device="cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert list(out["checks"]) == ["first_loss_gap", "loss_gap", "grad_gap",
                                   "zeroed_differ", "change_gap"]
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(run._json_safe(out)))


def test_traced_result_has_breakdown_and_device_times(root, monkeypatch):
    # the profiler needs a card: a capture of two device rows stands in
    from fedbench import counts, trace

    ops = [trace.Op("sgemm", 0.0, 300.0, trace.MATMUL,
                    frozenset({"fed_round", "fed_client_phase"})),
           trace.Op("sketch_estimates_kernel", 400.0, 100.0,
                    trace.EPILOGUE,
                    frozenset({"fed_round", "fed_server_phase"}))]
    spans = [("fed_round", 0.0, 500.0), ("fed_drain", 500.0, 900.0)]

    def fake_capture(run_round, rounds):
        for _ in range(rounds):
            run_round()
        return trace.Capture(rounds, ops, spans, (0.0, 1000.0))

    monkeypatch.setattr(trace, "capture", fake_capture)
    monkeypatch.setattr(counts, "peaks", lambda name: (3.35e12, 67e12,
                                                       16.7e12))
    out = harness.run(spec.cell("t-gpt2", root), 4, 0.2, True,
                      device="cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["device"]["busy_s"] == 0.0004
    assert out["device"]["window_s"] == 0.001
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["breakdown"]["idle_gaps"][0] == ["fed_drain", 0.0005]
    assert set(out["metrics"]) == {m["name"] for m in spec.cell(
        "t-gpt2", root).per_layer}
    assert out["metrics"]["device_idle_pct"]["value"] == 60.0


def test_non_finite_numbers_print_as_strings():
    assert run._json_safe({"a": [float("inf"), 1.0, float("nan")]}) == \
        {"a": ["inf", 1.0, "nan"]}


def test_guard_compares_top_level_names_whole():
    mods = {"jax": 0, "jaxlib.xla_client": 0, "flax.linen": 0,
            "commefficient_tpu.ops.sketch": 0, "commefficient_torch": 0,
            "commefficient_torch.ops": 0, "jaxtyping": 0, "fedbench": 0}
    assert run.forbidden_modules(mods) == [
        "commefficient_tpu.ops.sketch", "flax.linen", "jax",
        "jaxlib.xla_client"]


def _cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "fedbench.run", "--workload",
         "gpt2-sketch-w4", "--seed", "1", "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_no_card_exits_non_zero_with_no_result():
    got = _cli(tiny.REPO)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "CUDA" in got.stderr


def test_benchmark_alone_cannot_run(tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "fedbench", tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _cli(tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""
