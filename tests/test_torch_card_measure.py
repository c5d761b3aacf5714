"""The port's on-card measurement batch
(``commefficient_torch/scripts/card_measure.py``) against the JAX
package's ``scripts/tpu_measure.py``, on the CPU.

- The legs: the port's names and their order are the JAX script's
  (``known`` in its ``main`` and the order of its ``sel`` calls, read with
  ``ast``: importing the script would claim a TPU), and an unknown leg
  exits non-zero with the JAX script's message.
- The self-test: ``--device cpu`` of ``ops``, ``topk_ab`` and
  ``fused_epilogue`` at the tiny geometry in a child process, which loads
  neither ``jax`` nor ``commefficient_tpu``, prints one JSON line a leg
  with every equality flag true and writes them after the header.
- The wire bytes that ``compressed_collectives`` and ``multihost`` print
  (the fp32 and int8 plans on one rank; fp32 and the per-axis plan on the
  (clients 2) x (shard 2) grid with ``clients`` on ``dcn``) at the
  headline d: equal to the JAX package's ``collective_ledger`` at the
  same configuration, leg by leg, and so the ICI / DCN split.
- No hidden failures: a leg that raises, or one whose equality flag is
  false, gives exit 1 after the legs after it ran.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from commefficient_torch.scripts import card_measure as cm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 6_568_640


def _jax_legs():
    """``known`` and the order of ``sel(...)`` in the JAX script's main."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts",
                                       "tpu_measure.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    known = next(ast.literal_eval(n.value) for n in ast.walk(main)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "known")
    order = [n.args[0].value for n in ast.walk(main)
             if isinstance(n, ast.Call) and getattr(n.func, "id", None)
             == "sel"]
    return known, order


def test_legs_are_the_jax_scripts():
    known, order = _jax_legs()
    assert len(known) == 19
    assert set(cm.LEGS) == known
    assert list(cm.LEGS) == order
    assert set(cm.CARD_ONLY) < known


def test_unknown_leg_exits_with_the_jax_message():
    known, _ = _jax_legs()
    with pytest.raises(SystemExit) as e:
        cm.main(["ops", "bogus", "--device", "cpu"])
    assert e.value.code == (f"unknown legs ['bogus']; choose from "
                            f"{sorted(known)}")


SELFTEST_CHILD = """import json, runpy, sys
sys.argv = ["card_measure", "--device", "cpu", "ops", "topk_ab",
            "fused_epilogue", "--out", sys.argv[1]]
try:
    runpy.run_module("commefficient_torch.scripts.card_measure",
                     run_name="__main__")
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "commefficient_tpu"))}))
"""


def test_cpu_selftest_runs_without_jax(tmp_path):
    out = tmp_path / "cm.jsonl"
    env = dict(os.environ, COMMEFFICIENT_RUN_DIR=str(tmp_path / "run"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SELFTEST_CHILD, str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    child = lines.pop()
    assert child == {"rc": 0, "loaded": []}, child
    assert [r["leg"] for r in lines] == ["ops", "topk_ab", "fused_epilogue"]
    for r in lines:
        assert r["device"] == "cpu" and r["ok"], r
        assert r["equal"] and all(r["equal"].values()), r["equal"]
    # every arm of ops at both tiny d, both descents and torch.topk's k-th,
    # the epilogue's update and table
    assert len(lines[0]["equal"]) == 10
    assert len(lines[1]["equal"]) == 6
    assert len(lines[2]["equal"]) == 4
    header, *rows = [json.loads(line) for line in out.read_text()
                     .splitlines()]
    assert header["card"] is None and header["device"] == "cpu"
    assert rows == lines


def _jax_ledger(spec, n_shard, axis_sizes=None, placement=None):
    """The JAX script's ledger rows (``compressed_collectives_leg`` and
    ``multihost_leg``) at the headline geometry."""
    from commefficient_tpu.ops import collectives as C
    from commefficient_tpu.ops import sketch as sk
    from commefficient_tpu.telemetry import collective_ledger

    geo = sk.make_sketch(D, c=500_000, r=5, seed=42, num_blocks=20)
    plan = C.parse_collective_plan(spec)
    axes = tuple(axis_sizes or ())
    low = ({leg: C.resolve_leg_lowering(getattr(plan, leg), axes, placement)
            for leg in C.PLAN_LEGS} if plan.per_axis else None)
    led = collective_ledger("sketch", geo.d, sketch=geo, n_shard=n_shard,
                            plan=plan, lowering=low, axis_sizes=axis_sizes,
                            axis_placement=placement)
    rows = {name: row["bytes_per_round"] for name, row in led.items()
            if name != "client_uplink"}
    split = {"ici": 0, "dcn": 0}
    for name, row in led.items():
        if name == "client_uplink":
            continue
        pa = row.get("bytes_per_axis")
        if pa:
            for lvl in pa.values():
                split[lvl["placement"]] += lvl["bytes_per_round"]
        else:
            for ax, pl in (placement or {}).items():
                if ax in (axis_sizes or {}):
                    split[pl] += row["bytes_per_round"]
    return rows, split


@pytest.mark.parametrize("leg", ["compressed_collectives", "multihost"])
def test_printed_wire_bytes_equal_the_jax_ledger(leg):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if leg == "multihost":
            got = cm.multihost_ledgers(D, cm.SKETCH)
        else:
            got = cm.compressed_ledgers(D, cm.SKETCH, 1)
    printed = buf.getvalue().splitlines()
    assert len(printed) == 2
    for line, (tag, led) in zip(printed, got.items()):
        if leg == "multihost":
            spec = "" if tag == "fp32" else cm.MULTIHOST_PLAN
            rows, split = _jax_ledger(spec, 4, cm.MULTIHOST_AXES,
                                      cm.MULTIHOST_PLACEMENT)
            assert led["split"] == split, (tag, led["split"], split)
            assert (f"ICI {split['ici']:,} B/round, DCN "
                    f"{split['dcn']:,} B/round") in line
        else:
            rows, _ = _jax_ledger("" if tag == "fp32" else "int8", 1)
        assert led["legs"] == rows, (tag, led["legs"], rows)
        assert line.startswith(f"plan {tag}: ledger wire bytes/round "
                               f"{sum(rows.values()):,} (")
        for name, b in rows.items():
            assert f"{name}={b:,}B" in line
    if leg == "multihost":
        # the per-axis plan moves the clients hop at int8: fewer DCN bytes
        assert got["per-axis"]["split"]["dcn"] * 3 < \
            got["fp32"]["split"]["dcn"]


def _raise(m):
    raise RuntimeError("boom")


@pytest.mark.parametrize("first", ["raises", "false flag"])
def test_a_failed_leg_exits_nonzero_after_the_rest(first, tmp_path,
                                                   monkeypatch, capsys):
    bad = (_raise if first == "raises"
           else lambda m: {"x": 1.0, "equal": {"same": False}})
    ran = []

    def good(m):
        ran.append(m.dev)
        return {"x": 2.0, "equal": {"same": True}}

    monkeypatch.setitem(cm.LEG_FUNCS, "matmul", bad)
    monkeypatch.setitem(cm.LEG_FUNCS, "cifar", good)
    out = tmp_path / "cm.jsonl"
    rc = cm.main(["matmul", "cifar", "--device", "cpu", "--out", str(out)])
    assert rc == 1 and ran == ["cpu"]
    header, *rows = [json.loads(line) for line in out.read_text()
                     .splitlines()]
    assert header["legs"] == ["matmul", "cifar"]
    assert [(r["leg"], r["ok"]) for r in rows] == [("matmul", False),
                                                   ("cifar", True)]
    assert ("error" in rows[0]) == (first == "raises")
    text = capsys.readouterr().out
    assert "failed or unequal: ['matmul']" in text
    if first == "raises":
        assert "LEG FAILED [matmul]: RuntimeError: boom" in text
    monkeypatch.setitem(cm.LEG_FUNCS, "matmul", good)
    assert cm.main(["matmul", "cifar", "--device", "cpu", "--out",
                    str(out)]) == 0


def test_cpu_refuses_the_card_only_legs():
    with pytest.raises(SystemExit) as e:
        cm.main(["gpt2", "--device", "cpu"])
    assert e.value.code == 2
