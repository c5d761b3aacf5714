"""A configuration, a traffic mix and a per-layer metric added as files
alone, with entries in BENCHMARK.json, are found and run with no edit of
the harness."""

import json

import pytest

from fedbench import harness, spec
from fedbench.tests import tiny
from fedbench.trace import MATMUL, Capture, Op

READER = '''"""Device ms a round of the matmuls."""


def read(ctx):
    cap = ctx.capture
    us = sum(o.us for o in cap.ops if o.category == "matmul (cuBLAS)")
    return us / 1e3 / cap.rounds if cap.ops else None
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("root"))
    fb = root / "fedbench"
    cfg = json.loads((fb / "configs/t-resnet9.json").read_text())
    cfg["channels"]["layer3"] = 16
    cfg["d"] = None
    (fb / "configs/new-config.json").write_text(json.dumps(cfg))
    mix = json.loads((fb / "traffic/t-cifar.json").read_text())
    mix.update(clients_per_round=2, examples_per_client=3)
    mix["fields"]["inputs"]["shape"] = [3, 32, 32, 3]
    mix["fields"]["targets"]["shape"] = [3]
    (fb / "traffic/new-mix.json").write_text(json.dumps(mix))
    (fb / "metrics/matmul_device_ms.py").write_text(READER)
    (fb / "limits/new-cell.json").write_text(json.dumps(tiny.LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "test",
                             "file": "fedbench/configs/new-config.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "matmul_device_ms", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "client phase",
        "moves": "rounds_per_s", "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_new_files_make_a_cell(root):
    c = spec.cell("new-cell", root)
    assert c.config["channels"]["layer3"] == 16
    assert c.traffic["clients_per_round"] == 2
    assert "matmul_device_ms" in [m["name"] for m in c.per_layer]
    assert "matmul_device_ms" not in [
        m["name"] for m in spec.cell("t-resnet9", root).per_layer]
    out = harness.run(c, 5, 0.2, False, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"rounds_per_s", "round_ms_p95",
                                   "setup_s"}


def test_new_reader_reads_a_capture(root):
    c = spec.cell("new-cell", root)
    ops = [Op("sgemm", 0.0, 300.0, MATMUL, frozenset({"fed_round"})),
           Op("copy", 400.0, 100.0, "data movement", frozenset())]
    cap = Capture(2, ops, [("fed_round", 0.0, 500.0)], (0.0, 500.0))
    ctx = harness.Context(cap, c, 1.0, "cpu")
    assert spec.reader(c, "matmul_device_ms").read(ctx) == 0.15
    empty = harness.Context(Capture(2, [], [], (0.0, 1.0)), c, 1.0,
                            "cpu")
    assert spec.reader(c, "matmul_device_ms").read(empty) is None
