"""The port's ``commefficient_torch.scripts.host_offload_fullscale`` on the
CPU, in the JAX script's smoke geometry (``HOST_OFFLOAD_TINY=1``: 48
clients, d = 9,973, 3 x 1,024, 3 rounds):

- ``main(["--device", "cpu"])`` runs the forced host tier and passes its
  spot check, and writes nothing in tiny mode;
- the rows after the rounds equal a numpy ledger of the deltas (each
  round adds ``round + 1`` to every cell of the 8 rows it gathers),
  every cell of every row;
- the result carries every key of the JAX script's result dictionary
  (read from its source, which imports JAX at the top) and the port's;
- without a card the script refuses to start unless the CPU is asked
  for.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_torch.scripts import host_offload_fullscale as hof  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_KEYS = {"device", "probed_placement", "probed_plan", "forced_tier",
             "state_bytes", "rows_device", "staging_pinned",
             "resident_bytes", "resident_covers_state", "gather_ms",
             "scatter_ms", "spot_check"}


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setenv("HOST_OFFLOAD_TINY", "1")
    monkeypatch.chdir(tmp_path)


def jax_result_keys():
    """The keys of the ``result = {...}`` literal in the JAX script."""
    path = os.path.join(ROOT, "scripts", "host_offload_fullscale.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "result":
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dictionary in the JAX script")


def test_tiny_main_spot_check_and_keys(tiny, tmp_path):
    res = hof.main(["--device", "cpu"])
    assert res["tiny"] is True and res["placement"] == "host"
    assert res["forced_tier"] == "host" and res["probed_placement"] == "hbm"
    assert (res["num_clients"], res["table"], res["rounds"]) == \
        (48, [3, 1024], 3)
    assert res["spot_check"]["ok"] and res["resident_covers_state"]
    assert res["state_bytes"] == 48 * 3 * 1024 * 4
    assert res["platform"] == "cpu" and res["rows_device"] == "cpu"
    assert len(res["gather_ms"]) == len(res["scatter_ms"]) == 3
    want = jax_result_keys()
    assert want <= set(res), sorted(want - set(res))
    assert set(res) == want | PORT_KEYS, sorted(set(res) ^ (want | PORT_KEYS))
    assert not os.listdir(tmp_path)  # tiny mode writes nothing


def test_rows_equal_a_numpy_ledger(tiny):
    res, rows = hof.run(torch.device("cpu"), log=lambda *a: None)
    n, d, r, c, rounds = hof.TINY_GEOMETRY
    ledger = np.zeros((n,) + tuple(res["table"]), np.float32)
    rng = np.random.default_rng(0)
    for rd in range(rounds):
        ids = rng.choice(n, size=hof.W, replace=False)
        ledger[ids] += float(rd + 1)
    np.testing.assert_array_equal(rows.numpy(), ledger)
    assert {int(k): v for k, v in res["spot_check"]["touched"].items()} \
        == {int(k): float(ledger[int(k), 0, 0])
            for k in res["spot_check"]["touched"]}


def test_refuses_without_a_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        hof.main([])
