"""The port's ``commefficient_torch.scripts.multihost_demo`` and its tiny
geometries (``scripts/tiny_rounds.py``) on the CPU.

- In one process, from the JAX package's initial weights: the port's tiny
  sketched round (sketch and dense) equals the JAX driver entry's
  ``run_tiny_sketched_round`` on the 8-device CPU mesh (the kept set bit
  for bit, the weights to ``rtol=1e-4``), and the port's tiny engine
  (4 rounds, a one-rank group) equals ``run_tiny_engine`` there (its
  4 x 2 clients x shard mesh) to the same tolerance. The JAX package's
  own two-process legs (``tests/test_multihost.py``) cannot run on this
  jaxlib, so JAX's single-process runs are the reference.
- One spawn of 2 "nodes" x 2 gloo ranks under torchrun's environment
  (``multihost_demo.demo``) runs the fp32 sketch and dense rounds, the
  sketch round under a per-axis int8 plan and the engine leg with its
  run state after round 2; each leg equals the same run in one process
  on a one-rank group (``rtol=1e-4`` on the sums, fp32: the weights
  elementwise, the kept set bit for bit), the four ranks agree bit for
  bit, the clients axis is on ``dcn``, and the run state resumes on the
  one-rank group. The spawn runs while the JAX side computes.
- Without a card the script refuses to start unless the CPU is asked
  for.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_torch.scripts import multihost_demo as mh  # noqa: E402
from commefficient_torch.scripts import tiny_rounds as tr  # noqa: E402

W = mh.W
PLAN = "table=dcn:int8,downlink=dcn:int8"
LEGS = {"sketch-fp32": mh.make_leg("sketch"),
        "dense-fp32": mh.make_leg("uncompressed"),
        "sketch-dcn-int8": mh.make_leg("sketch", PLAN),
        "engine": mh.make_leg("sketch", engine=True)}
# the ranks' own deadline, below the wait for the spawn's thread
RANKS_TIMEOUT, SPAWN_TIMEOUT = 120, 150


@pytest.fixture(scope="module")
def both():
    """The spawn's legs (in a thread) and the JAX package's runs."""
    spawned = {}

    def spawn():
        try:
            spawned["legs"] = mh.demo(list(LEGS.values()), "cpu",
                                      log=lambda *a: None,
                                      timeout=RANKS_TIMEOUT)
        except BaseException as e:  # noqa: BLE001 -- raised in the test
            spawned["error"] = e

    th = threading.Thread(target=spawn, daemon=True)
    th.start()
    from __graft_entry__ import run_tiny_engine, run_tiny_sketched_round
    from commefficient_tpu.parallel.mesh import make_mesh

    mesh = make_mesh([("clients", W)])
    jax_out = {mode: run_tiny_sketched_round(mesh, W=W, mode=mode,
                                             donate=False)
               for mode in ("sketch", "uncompressed")}
    d = 12  # the Dense(4) kernel on 3 inputs; JAX returns the chunked view
    flat0 = np.asarray(run_tiny_engine(W=W, rounds=0, shard_devices=2)[0]
                       ).ravel()[:d]
    final = np.asarray(run_tiny_engine(W=W, rounds=4, shard_devices=2)[0]
                       ).ravel()[:d]
    jax_out["engine"] = (final, flat0)
    th.join(SPAWN_TIMEOUT)
    assert not th.is_alive(), "the spawned cohort did not finish"
    if "error" in spawned:
        raise spawned["error"]
    return dict(zip(LEGS, spawned["legs"])), jax_out


@pytest.mark.parametrize("mode", ["sketch", "uncompressed"])
def test_tiny_round_matches_jax(both, mode):
    jps, flat0 = both[1][mode]
    tps, tf0 = tr.run_tiny_sketched_round(W, mode=mode, init=flat0)
    np.testing.assert_array_equal(tf0, flat0)
    np.testing.assert_array_equal(tps != flat0, jps != flat0)
    np.testing.assert_allclose(tps, jps, rtol=1e-4, atol=1e-7)


def test_tiny_engine_matches_jax(both):
    final, flat0 = both[1]["engine"]
    with tr.one_rank_group(W) as g:
        w, ckpt = tr.run_tiny_engine(W, rounds=4, group=g, init=flat0)
    assert ckpt is None
    np.testing.assert_allclose(w, final, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("leg", list(LEGS))
def test_two_node_cohort_matches_one_process(both, leg):
    res = both[0][leg]
    spec = LEGS[leg]
    assert res["mode"] == spec["mode"] and res["plan"] == (spec["plan"]
                                                          or "fp32")
    assert len(res["ranks"]) == mh.WORLD
    assert [r["node"] for r in sorted(res["ranks"],
                                      key=lambda r: r["launcher_rank"])] \
        == [0, 0, 1, 1]
    for r in res["ranks"]:
        assert r["placement"]["clients"] == "dcn", r
        assert (r["sum"], r["absmax"], r["d"]) == (
            res["ranks"][0]["sum"], res["ranks"][0]["absmax"],
            res["ranks"][0]["d"])
    ref = res["reference"]
    np.testing.assert_allclose(res["ranks"][0]["sum"], ref["sum"],
                               rtol=1e-4, atol=1e-6)
    if not spec["plan"]:
        # fp32: the sums differ in order only
        assert res["max_abs_diff"] <= 1e-6, res["max_abs_diff"]
    if spec["engine"]:
        assert res["ranks"][0]["ckpt"]
        np.testing.assert_allclose(res["elastic"]["sum"],
                                   res["ranks"][0]["sum"], rtol=1e-4,
                                   atol=1e-6)
        assert res["ranks"][0]["d"] == 12
    else:
        assert res["ranks"][0]["d"] == 8044


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        mh.main([])
