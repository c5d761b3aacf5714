"""The port's quantized collectives (``commefficient_torch/ops/collectives.py``)
against the JAX package's (``commefficient_tpu/ops/collectives.py``),
mirroring ``tests/test_compressed_collectives.py``.

- ``quantize_blocks`` given JAX's own ``jax.random.uniform`` draws: the
  payload bytes and the scales equal JAX's bit for bit for int8, fp8_e4m3
  and int4 (the packing, an odd block, an all-zero block included), and
  so do the dequantized values.
- ``payload_bytes``, ``parse_collective_plan`` (the same spellings
  accepted and refused, the per-axis forms included; ``auto`` is refused
  by both parsers, as it is resolved by the probe) and the
  ``--reduce_dtype`` alias; a run state's per-level carries sliced as the
  JAX package lays them out; the 2-D plane's flags checked as the JAX
  package checks them.
- Stochastic rounding is unbiased on the port's own generator.
- On 2 and 4 ``gloo`` ranks (``tests/torch_dist_ranks.py``) against
  ``shard_map`` over a 2- and 4-device slice of the 8-device CPU mesh,
  each rank given JAX's uniforms for its rank (``fold_in(key, rank)``):
  the reduce-scatter tile equals the all-reduce's slice, the all-gather
  is exact, and the quantized reduce-scatter, all-reduce and all-gather
  give JAX's outputs and new remainders bit for bit. Conservation (sum of
  the transmitted values and the new remainders against the
  contributions plus the old remainders) holds at JAX's ``atol=5e-5``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from commefficient_tpu.compat import shard_map  # noqa: E402
from commefficient_tpu.ops import collectives as J  # noqa: E402
from commefficient_torch.ops import collectives as C  # noqa: E402
from tests.torch_dist_ranks import start_ranks  # noqa: E402

DTYPES = ["int8", "fp8_e4m3", "int4"]


def _bits(q, dtype):
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if dtype == "fp8_e4m3" else q).numpy()
    q = jax.lax.bitcast_convert_type(q, jnp.uint8) \
        if dtype == "fp8_e4m3" else q
    return np.asarray(q)


def _blocks(seed, shape):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 3).astype(np.float32)
    x[1] = 0.0                      # an all-zero block
    x[2] *= 1e3                     # a wide block
    x[3, :4] = [0.0, -0.0, 448.0, -1e-3]
    return x


@pytest.mark.parametrize("block", [128, 77])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_blocks_bit_equal_to_jax(dtype, block):
    x = _blocks(block, (6, block))
    key = jax.random.key(block + 3)
    u = np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32))
    jq, js = J.quantize_blocks(jnp.asarray(x), key, dtype)
    tq, ts = C.quantize_blocks(torch.from_numpy(x), torch.from_numpy(u),
                               dtype)
    np.testing.assert_array_equal(_bits(tq, dtype), _bits(jq, dtype))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    if dtype == "int4":
        assert tuple(tq.shape) == (6, (block + 1) // 2)
    assert not ts[1].item() and not C.dequantize_blocks(
        tq, ts, dtype, block)[1].any()
    jd = np.asarray(J.dequantize_blocks(jq, js, dtype, block))
    td = C.dequantize_blocks(tq, ts, dtype, block).numpy()
    np.testing.assert_array_equal(td.view(np.uint32), jd.view(np.uint32))


def test_int4_pack_unpack_roundtrip():
    q = np.random.RandomState(0).randint(-7, 8, (5, 33)).astype(np.float32)
    p = C._pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(J._pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(C._unpack_int4(p, 33).numpy(), q)


def test_payload_bytes_equal_jax():
    for dtype in J.WIRE_DTYPES:
        for size in (1, 77, 8192, 8193, 1_000_003):
            for block in (None, 1, 77, 128, 8192, 500_096):
                assert C.payload_bytes(size, dtype, block) == \
                    J.payload_bytes(size, dtype, block), (dtype, size, block)


SPELLINGS = ["", "int8", "fp32", "float32", "fp8", "fp8_e4m3", "int4",
             "uplink=int8", "uplink=int8,downlink=fp8_e4m3,table=int4",
             " table = int4 , ", "downlink=fp8", "uplink=int8,",
             # refused by both
             "int16", "uplink=int8,uplink=int4", "sideways=int8",
             "uplink", "uplink=bf16"]


@pytest.mark.parametrize("spec", SPELLINGS)
def test_parse_collective_plan_like_jax(spec):
    try:
        want = J.parse_collective_plan(spec)
    except AssertionError:
        with pytest.raises(AssertionError):
            C.parse_collective_plan(spec)
        return
    got = C.parse_collective_plan(spec)
    assert got.spec() == want.spec()
    assert got.quantized == want.quantized


@pytest.mark.parametrize("spec", ["auto", "uplink=ici:fp32/dcn:int8",
                                  "ici:fp32/dcn:int8"])
def test_deferred_plans_raise_item_5a(spec):
    """The plans that once raised naming item 5a: ``auto`` is refused by
    both parsers (the probe resolves it first), and a per-axis spec
    parses to the JAX package's plan."""
    if spec == "auto":
        with pytest.raises(AssertionError, match="autotune"):
            J.parse_collective_plan(spec)
        with pytest.raises(AssertionError, match="autotune"):
            C.parse_collective_plan(spec)
        return
    want, got = J.parse_collective_plan(spec), C.parse_collective_plan(spec)
    assert got.spec() == want.spec()
    assert got.per_axis and want.per_axis
    assert got.quantized == want.quantized


def test_legacy_alias_like_jax():
    for rd in ("float32", "int8"):
        assert C.plan_from_reduce_dtype(rd).spec() == \
            J.plan_from_reduce_dtype(rd).spec()


@pytest.mark.parametrize("dtype", DTYPES)
def test_stochastic_rounding_unbiased(dtype):
    """The mean of 4,000 quantize/dequantize draws on the port's own
    generator sits within 4 standard errors of x (the JAX test's
    bound)."""
    x = np.random.RandomState(1).randn(1, 256).astype(np.float32)
    xt = torch.from_numpy(x).expand(4000, 256).contiguous()
    gen = torch.Generator().manual_seed(7)
    u = torch.rand(xt.shape, generator=gen)
    q, s = C.quantize_blocks(xt, u, dtype)
    deq = C.dequantize_blocks(q, s, dtype, 256).numpy()
    err = deq.mean(0) - x[0]
    step = float(s[0]) * (1.0 if dtype != "fp8_e4m3" else 32.0)
    assert np.all(np.abs(err) <= 4 * step / np.sqrt(4000) + 1e-6)
    assert np.abs(err).mean() < 0.01 * step


# --------------------------------------------------------------------------
# across ranks
# --------------------------------------------------------------------------

def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("clients",))


def _u_shape(op, x_shape, n, block):
    size = int(np.prod(x_shape))
    if op == "qscatter":
        tile = size // n
        return (n, -(-tile // block), block)
    if op == "qpsum":
        blk = min(block, max(1, -(-size // n)))
        tile = -(-size // (n * blk)) * blk
        return (n, tile // blk, blk)
    return (-(-size // block), block)


def _jax_op(op, xs, key, block, dtype, res):
    n = xs.shape[0]
    fn = {"qscatter": J.quantized_psum_scatter, "qpsum": J.quantized_psum,
          "qgather": J.quantized_all_gather}[op]

    def inner(x, r):
        got, new = fn(x[0], "clients", key,
                      residual=None if res is None else r[0], block=block,
                      dtype=dtype)
        return got[None], new[None]

    rr = jnp.zeros_like(xs) if res is None else jnp.asarray(res)
    # eager, as the JAX package's own collective tests run it (under jit
    # XLA may rewrite the division by the scale)
    got, new = shard_map(inner, mesh=_mesh(n),
                         in_specs=(P("clients"), P("clients")),
                         out_specs=(P("clients"), P("clients")),
                         check_vma=False)(jnp.asarray(xs), rr)
    return np.asarray(got), np.asarray(new)


def _cases(n):
    """The cases of n ranks (JAX's uniforms included) and the arguments of
    their JAX counterparts."""
    rs = np.random.RandomState(n)
    x = rs.randn(n, 8 * n, 3).astype(np.float32)
    cases = [{"op": "reduce_scatter", "x": x}, {"op": "all_gather", "x": x}]
    jax_args = []
    # each op once at each n, each dtype once at each n (an eager
    # shard_map call costs seconds)
    plan = {2: [("qscatter", "int8", (4 * n, 50), 64, True),
                ("qpsum", "int4", (3, 7), 8192, False),
                ("qgather", "fp8_e4m3", (5, 2, 128), 256, True)],
            4: [("qscatter", "fp8_e4m3", (2 * n, 77), 77, False),
                ("qpsum", "int8", (3, 200), 128, True),
                ("qgather", "int4", (33,), 8, True)]}[n]
    for i, (op, dtype, shape, block, with_res) in enumerate(plan):
        xs = (rs.randn(n, *shape) * 2).astype(np.float32)
        res = (rs.randn(n, *shape).astype(np.float32) * 0.01
               if with_res else None)
        key = jax.random.key(40 + i)
        u = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(key, r), _u_shape(op, shape, n, block),
            dtype=jnp.float32)) for r in range(n)])
        cases.append({"op": op, "x": xs, "residual": res, "block": block,
                      "dtype": dtype, "u": u})
        jax_args.append((op, xs, key, block, dtype, res))
    return cases, jax_args


@pytest.fixture(scope="module")
def across_ranks(tmp_path_factory):
    """One spawn of 4 ranks: the 2-rank cases on ranks 0-1, then the
    4-rank cases; JAX's side is computed while the ranks run, its eager
    calls in 3 threads (each call's time is mostly XLA compiling its
    primitives one by one, which runs outside the GIL)."""
    cases = {n: _cases(n) for n in (2, 4)}
    with start_ranks(4, [("body_collectives", cases[n][0], n)
                         for n in (2, 4)],
                     tmp_path_factory.mktemp("collectives")) as ranks, \
            ThreadPoolExecutor(3) as pool:
        futures = {n: [pool.submit(_jax_op, *a) for a in cases[n][1]]
                   for n in (2, 4)}
        want = {n: [f.result() for f in fs] for n, fs in futures.items()}
        outs = dict(zip((2, 4), ranks.join()))
    return {n: (cases[n][0], want[n], outs[n]) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_across_ranks_equal_jax(n, across_ranks):
    cases, want, outs = across_ranks[n]
    x = cases[0]["x"]
    total = x.sum(0) if n == 2 else None
    for r in range(n):
        rs_out, ag_out = outs[r][0], outs[r][1]
        per = x.shape[1] // n
        # the reduce-scatter tile is the all-reduce's slice, bit for bit
        np.testing.assert_array_equal(rs_out["tile"],
                                      rs_out["sum"][r * per:(r + 1) * per])
        if total is not None:  # a sum of two addends has one order
            np.testing.assert_array_equal(rs_out["sum"], total)
        np.testing.assert_array_equal(ag_out["full"],
                                      x.reshape(-1, *x.shape[2:]))
        for case, (jgot, jnew), got in zip(cases[2:], want, outs[r][2:]):
            what = f"{case['op']} {case['dtype']} rank {r}"
            np.testing.assert_array_equal(got["res"], jnew[r], err_msg=what)
            np.testing.assert_array_equal(got["out"], jgot[r], err_msg=what)
    # conservation: what was transmitted plus what is carried is what
    # was contributed plus what was carried before
    for case, j in zip(cases[2:], range(2, len(cases))):
        res0 = case["residual"]
        contrib = case["x"] + (0 if res0 is None else res0)
        new_res = np.stack([outs[r][j]["res"] for r in range(n)])
        if case["op"] == "qgather":
            sent = outs[0][j]["out"].reshape(contrib.shape)
            np.testing.assert_allclose(sent + new_res, contrib, atol=5e-5)
        elif case["op"] == "qpsum":
            np.testing.assert_allclose(outs[0][j]["out"] + new_res.sum(0),
                                       contrib.sum(0), atol=5e-5)
        else:
            tiles = np.concatenate([outs[r][j]["out"] for r in range(n)])
            np.testing.assert_allclose(tiles + new_res.sum(0),
                                       contrib.sum(0), atol=5e-5)


@pytest.mark.parametrize("key", ["server/qres.0", "server/dres.1"])
def test_per_axis_run_state_carries_raise_item_5a(key):
    """A run state of the JAX package's per-axis plans (one key a level)
    is no longer refused: each rank of a (clients = 2) x (shard = 2) grid
    takes its part of the level's global array, as the JAX package lays
    it out (``qres.<j>`` stacked over the reduce tuple, ``dres.<j>``
    tiled over axes ``0..j``), and a geometry the run does not have is
    no part (the restore then starts the level from zero)."""
    from types import SimpleNamespace

    from commefficient_torch.federated import checkpoint as tck

    name, j = key.split("/")[1].split(".")
    j = int(j)
    n_clients = n_shard = 2
    glob = np.arange(4 * 6, dtype=np.float32).reshape(4, 6) \
        if name == "qres" else np.arange(8 * 3, dtype=np.float32)
    for p in range(4):
        s, c = divmod(p, n_clients)
        group = SimpleNamespace(rank=p, size=4)
        shard_axis = SimpleNamespace(rank=s, size=n_shard)
        tiles = shard_axis if j == 0 else group
        if name == "qres":
            got = tck._carry_part(glob, name, (6,), group, tiles)
            np.testing.assert_array_equal(got, glob[p])
        else:
            per = glob.shape[0] // tiles.size
            got = tck._carry_part(glob, name, (per,), group, tiles)
            np.testing.assert_array_equal(
                got, glob[tiles.rank * per:(tiles.rank + 1) * per])
        assert tck._carry_part(glob, name, (5,), group, tiles) is None
        assert tck._carry_part(None, name, (6,), group, tiles) is None


@pytest.mark.parametrize("argv", [["--shard_devices", "2"],
                                  ["--collective_plan", "auto"],
                                  ["--collective_plan",
                                   "uplink=ici:fp32/dcn:int8"]])
def test_deferred_flags_raise_item_5a(argv):
    """The flags that once raised naming item 5a carry the JAX package's
    checks: alone each needs ``--server_shard`` (the same message from
    both parsers); with it both parsers give the same values."""
    from commefficient_tpu.config import parse_args as j_parse
    from commefficient_torch.config import parse_args as t_parse

    with pytest.raises(AssertionError, match="require") as want:
        j_parse(argv=argv + ["--no_telemetry"])
    with pytest.raises(AssertionError, match="require") as got:
        t_parse(argv=["--device", "cpu"] + argv)
    assert str(got.value) == str(want.value)
    argv = argv + ["--server_shard"]
    ja = j_parse(argv=argv + ["--no_telemetry"])
    ta = t_parse(argv=["--device", "cpu"] + argv)
    for dest in ("shard_devices", "collective_plan", "plan_error_budget",
                 "server_shard"):
        assert getattr(ta, dest) == getattr(ja, dest), dest


@pytest.mark.parametrize("argv,msg", [
    (["--reduce_dtype", "int8"], "requires --server_shard"),
    (["--collective_plan", "int8"], "require --server_shard"),
    (["--server_shard", "--reduce_dtype", "int8", "--collective_plan",
      "int4"], "both name wire dtypes"),
    (["--server_shard", "--topk_down"], "incompatible with --topk_down")])
def test_collective_flag_checks_like_jax(argv, msg):
    """The JAX package's checks of the sharded server's flags, raised at
    parse time by both packages."""
    from commefficient_tpu.config import parse_args as j_parse
    from commefficient_torch.config import parse_args as t_parse

    with pytest.raises(AssertionError, match=msg):
        j_parse(argv=argv + ["--no_telemetry"])
    with pytest.raises(AssertionError, match=msg):
        t_parse(argv=["--device", "cpu"] + argv)


@pytest.mark.parametrize("num_workers,num_devices,world", [
    (8, -1, 4), (6, -1, 4), (8, 2, 4), (8, 3, 4), (7, -1, 8), (4, 8, 2),
    (8, -1, 1)])
def test_client_group_size_is_the_jax_mesh_policy(num_workers, num_devices,
                                                  world):
    """``min(--num_devices, world)`` reduced to the largest divisor of
    ``num_workers``: the clients axis of the JAX package's
    ``default_client_mesh`` over ``world`` devices."""
    import warnings

    from commefficient_tpu.parallel.mesh import default_client_mesh
    from commefficient_torch.parallel.mesh import client_group_size

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = default_client_mesh(num_workers, num_devices,
                                   devices=jax.devices()[:world]).size
        got = client_group_size(num_workers, num_devices, world)
    assert got == want
