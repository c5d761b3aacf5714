"""The reference against the port's round on the CPU at the tiny
geometry, and the reference's count sketch and top-k alone."""

import numpy as np
import pytest
import torch

from fedbench import harness, spec, traffic
from fedbench.reference.sketch import CountSketch, fmix32, topk
from fedbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("root"))


def _fmix32_py(x: int) -> int:
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & m
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def test_fmix32_matches_python_integers():
    xs = [0, 1, 2, 12345, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF]
    got = fmix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [_fmix32_py(x) for x in xs]


def test_sketch_is_linear_and_a_lone_coordinate_is_recovered():
    cs = CountSketch(d=5000, c=300, r=5, seed=3, device="cpu")
    assert (cs.c_pad, cs.T) == (384, 14)
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5000, generator=g)
    b = torch.randn(5000, generator=g)
    torch.testing.assert_close(cs.sketch(a + b), cs.sketch(a) + cs.sketch(b),
                               rtol=0, atol=1e-4)
    one = torch.zeros(5000)
    one[4321] = -2.5
    est = cs.query(cs.sketch(one))
    assert est[4321] == -2.5 and est.abs().sum() == 2.5


def test_topk_keeps_every_tie_at_the_cut():
    v = torch.tensor([3.0, -2.0, 2.0, 1.0, -4.0, 0.0])
    assert topk(v, 3).tolist() == [3.0, -2.0, 2.0, 0.0, -4.0, 0.0]
    assert topk(v, 10).tolist() == v.tolist()


@pytest.mark.parametrize("name", tiny.CELLS)
def test_reference_follows_the_port(root, name):
    c = spec.cell(name, root)
    s = harness.seeds(2**31 + 77)
    pool = traffic.rounds(c.traffic, s.data)
    p = harness.Program(c, s, "cpu", str(root / f"log-{name}"))
    prog = harness.first_rounds(p, pool)
    p.close()
    ref = harness.reference_rounds(c, s, pool, "cpu")
    got = harness.compare(prog, ref)
    assert all(v <= 1e-6 for v in got.values()), got
    # the port moved: the checked rounds are not a fixed point
    assert float((ref["weights"] - ref["w0"]).abs().max()) > 0
    assert np.all(np.isfinite(prog["losses"]))
