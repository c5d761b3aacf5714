"""The port's per-client state modules (``commefficient_torch/federated/
memory.py``, ``federated/host_state.py``, ``profiling.offpath_fetches``)
against the JAX package's on the CPU, module by module, with the same
seeded numpy inputs on both sides.

- The planner: with explicit budgets (and with the two environment
  overrides) every field of the plan equals JAX's plan without a mesh;
  on JAX's 8-device mesh JAX divides ``per_device_bytes`` over 8 shards
  while the port, which replicates client rows on every rank, keeps 1
  shard and the total (the documented difference).
- The storage-fault plane: ``parse_io_fault`` gives the same schedule (or
  the same exception type), and the injector's draws, counts and
  ``flip_pos`` equal JAX's draw for draw.
- The CRC helpers: ``_crc32_zeros`` and ``_crc32_combine`` equal zlib's
  and JAX's; ``_file_crc`` / ``_copy_sparse`` equal JAX's on a sparse
  file, and the copy is byte-equal and as sparse.
- The row store: the same gathers and scatters (a duplicate id, a padded
  slot of zero delta, contiguous runs that coalesce, the ``--topk_down``
  init-row base) leave byte-equal backing files, CRC sidecars, snapshot
  files and ``store.json`` in both packages, and the same gathered rows
  (exactly); the retry ladder under injected EIO / short reads / torn
  writes, quarantine, scrub with silent flips and the repair from the
  snapshot, the watchdog's fatal error, ``write_full`` / ``read_full``
  and ``read_snapshot_member`` match JAX's counters, events and bytes.
- ``RowDirectory.state()`` and the prefetcher's hit / miss / discard
  sequence equal JAX's; ``RowStreamer`` (the host tier) applies the same
  slot-order adds as the disk tier.
- A fetch on a thread inside ``offpath_fetches`` is not counted by the
  main thread's ``host_sync_monitor``.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.federated import host_state as jhs  # noqa: E402
from commefficient_tpu.federated import memory as jmem  # noqa: E402
from commefficient_tpu.federated.rounds import ClientStates as JCS  # noqa: E402
from commefficient_tpu.federated.worker import WorkerConfig as JWcfg  # noqa: E402
from commefficient_tpu.ops.sketch import make_sketch as j_make_sketch  # noqa: E402
from commefficient_torch.federated import host_state as ths  # noqa: E402
from commefficient_torch.federated import memory as tmem  # noqa: E402
from commefficient_torch.federated.rounds import ClientStates as TCS  # noqa: E402
from commefficient_torch.federated.worker import WorkerConfig as TWcfg  # noqa: E402
from commefficient_torch.ops.sketch import make_sketch as t_make_sketch  # noqa: E402
from commefficient_torch.profiling import (  # noqa: E402
    host_sync_monitor,
    materialize,
    offpath_fetches,
)

GIB = 1024 ** 3


# -- the planner -------------------------------------------------------------

PLAN_CFGS = {
    "sketch_local": dict(mode="sketch", error_type="local",
                         local_momentum=0.9),
    "sketch_virtual": dict(mode="sketch", error_type="virtual"),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=50),
    "topk_down": dict(mode="true_topk", error_type="virtual",
                      do_topk_down=True, k=50),
    "fedavg": dict(mode="fedavg"),
}


def _plans(cfg, n, d, **budgets):
    kw = dict(PLAN_CFGS[cfg], num_workers=8)
    jsk = j_make_sketch(d, 500000, 5, seed=0, num_blocks=1) \
        if kw["mode"] == "sketch" else None
    tsk = t_make_sketch(d, 500000, 5, seed=0, num_blocks=1, device="cpu") \
        if kw["mode"] == "sketch" else None
    j = jmem.plan_client_state_memory(n, d, JWcfg(**kw), sketch=jsk,
                                      **budgets)
    t = tmem.plan_client_state_memory(n, d, TWcfg(**kw), sketch=tsk,
                                      device="cpu", **budgets)
    return j, t


@pytest.mark.parametrize("cfg", sorted(PLAN_CFGS))
@pytest.mark.parametrize("budgets", [
    dict(hbm_budget_bytes=80 * GIB, host_budget_bytes=48 * GIB),
    dict(hbm_budget_bytes=1, host_budget_bytes=48 * GIB),
    dict(hbm_budget_bytes=1, host_budget_bytes=1),
    dict(hbm_budget_bytes=10 * GIB, host_budget_bytes=100 * GIB)])
def test_plan_matches_jax(cfg, budgets):
    """ResNet9's width (d = 6,568,640, the published 5 x 500,000 sketch)
    at the EMNIST population: every field equals JAX's plan."""
    j, t = _plans(cfg, 3500, 6568640, **budgets)
    assert t == tmem.ClientStateMemoryPlan(**vars(j))
    assert t.summary() == j.summary()


def test_plan_bytes_and_env_overrides(monkeypatch):
    """The sketch-local row is 10,001,920 B, 65.21 GiB at 3,500 clients;
    the overrides are read per call and win over an explicit probe, as
    JAX's."""
    for k in ("COMMEFFICIENT_STATE_HBM_BUDGET",
              "COMMEFFICIENT_STATE_HOST_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    j, t = _plans("sketch_local", 3500, 6568640)
    assert t.row_bytes == 10001920 and t.total_bytes == 70013440000
    assert f"{t.total_bytes / GIB:.2f}" == "65.21"
    # the CPU's device budget is JAX's 8 GiB default: 65 GiB goes off it
    assert t.placement == j.placement != "hbm"
    j, t = _plans("local_topk", 3500, 6568640)
    assert t.total_bytes == 2 * 3500 * 26274560 == j.total_bytes
    for hbm, host, want in (("1", str(2 ** 62), "host"), ("1", "1", "disk"),
                            (str(2 ** 62), "1", "hbm")):
        monkeypatch.setenv("COMMEFFICIENT_STATE_HBM_BUDGET", hbm)
        monkeypatch.setenv("COMMEFFICIENT_STATE_HOST_BUDGET", host)
        j, t = _plans("sketch_local", 12, 5000)
        assert t.placement == j.placement == want
    assert tmem._host_ram_budget() == jmem._host_ram_budget()
    assert tmem._device_hbm_budget("cpu") == 8 * GIB


def test_plan_replicated_shards_differ_from_jax_mesh():
    """JAX shards client rows over its clients axis and divides the total;
    the port replicates rows on every rank: 1 shard, the total."""
    from commefficient_tpu.parallel.mesh import default_client_mesh

    mesh = default_client_mesh(8)
    kw = dict(PLAN_CFGS["sketch_local"], num_workers=8)
    jsk = j_make_sketch(5000, 2048, 3, seed=0, num_blocks=1)
    tsk = t_make_sketch(5000, 2048, 3, seed=0, num_blocks=1, device="cpu")
    j = jmem.plan_client_state_memory(16, 5000, JWcfg(**kw), sketch=jsk,
                                      mesh=mesh, hbm_budget_bytes=2 ** 40,
                                      host_budget_bytes=2 ** 40)
    t = tmem.plan_client_state_memory(16, 5000, TWcfg(**kw), sketch=tsk,
                                      hbm_budget_bytes=2 ** 40,
                                      host_budget_bytes=2 ** 40)
    assert j.num_shards == 8 and j.per_device_bytes == j.total_bytes // 8
    assert t.num_shards == 1 and t.per_device_bytes == t.total_bytes
    assert t.total_bytes == j.total_bytes
    assert tmem.state_device(t, "cpu") == torch.device("cpu")
    for placement, want in (("host", torch.device("cpu")), ("disk", None)):
        p = tmem.ClientStateMemoryPlan(**dict(vars(t), placement=placement))
        assert tmem.state_device(p, "cpu") == want


# -- the storage-fault plane -------------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "eio=0.1", "eio=0.02,short=0.01,torn=0.01,seed=3",
    "flip=0.01,storn=0.02,stall=0.1,stall_ms=7,persist_after=2",
    " eio=0.5 , seed=9 ,", "eio=0.6,short=0.6", "eio=1.5", "stall_ms=0",
    "persist_after=0", "bogus=1", "eio", "eio=x", "seed=1.5"])
def test_parse_io_fault(spec):
    def run(f):
        try:
            s = f(spec)
            return ("ok", (vars(s), s.active, s.spec()))
        except Exception as e:  # noqa: BLE001 - the type is compared
            return ("raise", type(e))
    assert run(ths.parse_io_fault) == run(jhs.parse_io_fault)


def test_injector_draws_and_flip_pos_match_jax():
    spec = "eio=0.1,short=0.1,torn=0.1,stall=0.05,flip=0.1,storn=0.1,seed=5"
    ti = ths.IOFaultInjector(ths.parse_io_fault(spec))
    ji = jhs.IOFaultInjector(jhs.parse_io_fault(spec))
    for i in range(600):
        assert ti.draw() == ji.draw(), i
        assert ti.flip_pos(i * 7, 4096) == ji.flip_pos(i * 7, 4096)
    assert ti.injected == ji.injected
    assert ti.rng.random_sample() == ji.rng.random_sample()
    idle = ths.IOFaultInjector(ths.parse_io_fault("seed=1"))
    assert idle.draw() is None
    assert idle.rng.random_sample() == np.random.RandomState(1) \
        .random_sample()


# -- the CRC helpers ---------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 4096, 1 << 20, 123457])
def test_crc32_zeros(n):
    import zlib

    base = zlib.crc32(b"abc")
    want = zlib.crc32(b"\x00" * n, base)
    assert ths._crc32_zeros(base, n) == want == jhs._crc32_zeros(base, n)
    assert ths._crc32_combine(base, zlib.crc32(b"xy"), 2) == \
        zlib.crc32(b"abcxy")


def test_sparse_file_crc_and_copy_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "rows.f32"
    size = 64 << 20
    with open(path, "wb") as f:
        f.truncate(size)
        for off in (0, 5 << 20, 33 << 20, size - 4096):
            f.seek(off)
            f.write(rng.bytes(4096 * 3 if off < size - 4096 else 4096))
        f.seek(9 << 20)
        f.write(b"\x00" * (1 << 20))  # written zeros
    assert ths._file_crc(str(path)) == jhs._file_crc(str(path))
    a, b = tmp_path / "a.f32", tmp_path / "b.f32"
    assert ths._copy_sparse(str(path), str(a)) == \
        jhs._copy_sparse(str(path), str(b)) == ths._file_crc(str(path))
    assert a.read_bytes() == b.read_bytes() == path.read_bytes()
    assert os.stat(a).st_blocks == os.stat(b).st_blocks
    with open(path, "rb") as f:
        assert list(ths._data_extents(f.fileno(), size)) == \
            list(jhs._data_extents(f.fileno(), size))


# -- the row store -----------------------------------------------------------

ROWS = 12
SHAPES = {"velocities": (3, 40), "errors": (3, 40), "weights": (96,)}
# a duplicate id (4 twice), a padded slot (0, zero delta), contiguous
# runs that coalesce (5-8), and singles
COHORTS = [[4, 9, 4, 0], [5, 6, 7, 8], [0, 1, 11, 3], [6, 7, 2, 0],
           [10, 11, 4, 5], [1, 2, 3, 9]]
ZERO_SLOTS = {0: [3], 2: [], 3: [3]}


def _deltas(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for r, ids in enumerate(COHORTS):
        d = {n: rng.randn(len(ids), *s).astype(np.float32)
             for n, s in SHAPES.items()}
        for slot in ZERO_SLOTS.get(r, []):
            for v in d.values():
                v[slot] = 0.0
        out.append(d)
    return out


def _base():
    return {"weights": np.random.RandomState(7).randn(96).astype(np.float32)}


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _drive(pkg, d, inject="", deltas=None, rounds=None, snap_at=None,
           **kw):
    """The same operations on one package's store; returns what it left:
    the gathered rows, the files, the sidecars, the counters, events and
    the snapshot's files and meta."""
    cs, mk = ((TCS, torch.from_numpy) if pkg is ths
              else (JCS, jnp.asarray))
    kw.setdefault("io_backoff_ms", 0.0)
    store = pkg.MemmapRowStore(
        str(d), ROWS, SHAPES, init_rows=_base(),
        inject=pkg.parse_io_fault(inject) if inject else None, **kw)
    deltas = deltas if deltas is not None else _deltas()
    got, events, fatal, meta = [], [], None, None
    try:
        for r, ids in enumerate(COHORTS[:rounds]):
            s = store.gather(np.asarray(ids))
            old = {n: _np(getattr(s.proxy, n)).copy() for n in SHAPES}
            got.append(old)
            new = {n: old[n] + deltas[r][n] for n in SHAPES}
            store.scatter(s, cs(**{n: mk(v) for n, v in old.items()}),
                          cs(**{n: mk(v) for n, v in new.items()}))
            store.scrub_async()
            store.drain()
            events.extend(store.pop_events())
            if snap_at == r:
                meta = store.save_snapshot(str(d / "snap"))
        store.drain()
    except pkg.StoreFatalError as e:  # the terminal rung, compared
        fatal = str(e).split(" (store ")[0]
    out = {"got": got, "events": events, "counters": store.io_counters(),
           "fatal": fatal,
           "files": {n: open(store.member_path(n), "rb").read()
                     for n in SHAPES},
           "crc": ({n: store._crc[n].copy() for n in SHAPES}
                   if store._crc is not None else None),
           "full": (None if fatal else
                    {n: store.read_full(n) for n in SHAPES})}
    if meta is not None:
        out["meta"] = meta
        out["snap"] = {f: open(d / "snap" / f, "rb").read()
                       for f in sorted(os.listdir(d / "snap"))}
    rep = store.close()
    out["close"] = dict(rep, error=rep["error"] and
                        rep["error"].split(" (store ")[0])
    return out


def _same(t, j):
    assert len(t["got"]) == len(j["got"])
    for a, b in zip(t["got"], j["got"]):
        for n in SHAPES:
            np.testing.assert_array_equal(a[n].view(np.uint32),
                                          b[n].view(np.uint32))
    assert t["files"] == j["files"]
    if j["crc"] is None:
        assert t["crc"] is None
    else:
        for n in SHAPES:
            np.testing.assert_array_equal(t["crc"][n], j["crc"][n])
    assert t["fatal"] == j["fatal"]
    for n in SHAPES if j["full"] is not None else ():
        np.testing.assert_array_equal(t["full"][n].view(np.uint32),
                                      j["full"][n].view(np.uint32))
    assert t["counters"] == j["counters"]
    assert t["events"] == j["events"]
    assert t["close"] == j["close"]
    if "meta" in j:
        assert t["meta"] == j["meta"]
        assert t["snap"] == j["snap"]


@pytest.mark.parametrize("case", ["clean", "no_checksums", "no_coalesce"])
def test_store_bytes_match_jax(tmp_path, monkeypatch, case):
    if case == "no_coalesce":
        monkeypatch.setenv("COMMEFFICIENT_IO_COALESCE", "0")
    kw = {"checksums": case != "no_checksums"}
    t = _drive(ths, tmp_path / "t", snap_at=3, **kw)
    j = _drive(jhs, tmp_path / "j", snap_at=3, **kw)
    _same(t, j)
    c = t["counters"]
    if case == "no_coalesce":
        assert c["coalesced_rows"] == 0
    else:
        assert c["coalesced_rows"] > 0
    # the duplicate id accumulates both slots' deltas, as .at[ids].add
    # does: row 4 took round 0's slots 0 and 2 (within float32 rounding:
    # the store adds new - old, not the delta itself)
    d = _deltas()
    want4 = _base()["weights"] + d[0]["weights"][0] + d[0]["weights"][2]
    np.testing.assert_allclose(t["got"][4]["weights"][2], want4,
                               rtol=1e-6, atol=1e-6)
    # the files stay sparse: a row never touched reads as zeros from a
    # hole (rows 0-11 were all touched here; the snapshot's store.json)
    assert t["snap"]["store.json"] == j["snap"]["store.json"]


@pytest.mark.parametrize("inject", [
    "eio=0.15,short=0.1,torn=0.1,seed=3",
    "eio=0.3,seed=4,persist_after=1",
    "flip=0.08,storn=0.04,seed=11"])
def test_store_fault_ladder_matches_jax(tmp_path, inject):
    """Retried transient faults, quarantine, and silent flips caught by
    the checksums and repaired (re-read, snapshot) or quarantined, with
    a scrub of 4 rows a round: counters, events and bytes equal JAX's."""
    kw = dict(scrub_rows=4, io_retries=3)
    t = _drive(ths, tmp_path / "t", inject=inject, snap_at=1, **kw)
    j = _drive(jhs, tmp_path / "j", inject=inject, snap_at=1, **kw)
    _same(t, j)
    c = t["counters"]
    assert sum(c["injected"].values()) > 0
    if "flip" in inject:
        assert c["corrupt"] > 0 and c["scrub_checked"] > 0
    if "persist_after=1" in inject:
        assert c["quarantined"] > 0
        assert any(e["kind"] == "row_quarantined" for e in t["events"])
    elif "eio" in inject:
        assert c["retries"] > 0


def test_clean_retries_are_invisible(tmp_path):
    """Retried transient faults below the budget land the bytes of a
    clean run."""
    clean = _drive(ths, tmp_path / "c")
    noisy = _drive(ths, tmp_path / "n",
                   inject="eio=0.04,short=0.04,torn=0.04,seed=2")
    assert noisy["counters"]["retries"] > 0
    assert noisy["counters"]["quarantined"] == 0
    assert clean["files"] == noisy["files"]


def test_watchdog_fatal_matches_jax(tmp_path):
    outs = []
    for pkg, name in ((ths, "t"), (jhs, "j")):
        store = pkg.MemmapRowStore(
            str(tmp_path / name), 4, {"errors": (8,)},
            inject=pkg.parse_io_fault("stall=1.0,stall_ms=5000,seed=0"),
            io_deadline_ms=100.0, io_backoff_ms=0.0)
        with pytest.raises(pkg.StoreFatalError) as e:
            store.gather(np.array([1, 2]))
        with pytest.raises(pkg.StoreFatalError):
            store.gather(np.array([0]))
        rep = store.close(timeout=5.0)
        outs.append((type(store.fatal_error).__name__,
                     "watchdog deadline exceeded" in str(e.value),
                     rep["error"] is not None))
    assert outs[0] == outs[1] == ("StoreFatalError", True, True)


def test_write_full_read_snapshot_member_match_jax(tmp_path):
    """Cross-tier restore helpers: a full array written into the store
    (minus the init row, all-zero chunks left as holes) and a snapshot
    member lifted back (CRC-verified, plus its base)."""
    rng = np.random.RandomState(3)
    full = {"errors": rng.randn(ROWS, 3, 40).astype(np.float32),
            "weights": np.tile(_base()["weights"], (ROWS, 1))}
    full["errors"][5:9] = 0.0
    full["weights"][2] += 1.0
    res = []
    for pkg, name in ((ths, "t"), (jhs, "j")):
        d = tmp_path / name
        store = pkg.MemmapRowStore(str(d / "s"), ROWS,
                                   {"errors": (3, 40), "weights": (96,)},
                                   init_rows=_base())
        for n, a in full.items():
            store.write_full(n, a)
        meta = store.save_snapshot(str(d / "snap"))
        back = {n: pkg.read_snapshot_member(str(d / "snap"), meta, n)
                for n in full}
        res.append((meta, {n: open(store.member_path(n), "rb").read()
                           for n in full},
                    {n: store._crc[n].copy() for n in full}, back,
                    {n: store.read_full(n) for n in full}))
        store.close()
    (tm, tf, tc, tb, tr), (jm, jf, jc, jb, jr) = res
    assert tm == jm and tf == jf
    for n in full:
        np.testing.assert_array_equal(tc[n], jc[n])
        np.testing.assert_array_equal(tb[n], jb[n])
        np.testing.assert_array_equal(tr[n], full[n])
        np.testing.assert_array_equal(tb[n], full[n])
    with open(tmp_path / "t" / "snap" / "errors.f32", "r+b") as f:
        f.seek(100)
        f.write(b"\x01")
    with pytest.raises(RuntimeError, match="snapshot corrupt"):
        ths.read_snapshot_member(str(tmp_path / "t" / "snap"), tm, "errors")


def test_restore_snapshot_across_packages(tmp_path):
    """A store snapshot written by either package restores in the other
    (the CRC-checked copy-back, the sidecar and the base row)."""
    for src, dst in ((ths, jhs), (jhs, ths)):
        d = tmp_path / f"{src.__name__.split('.')[0]}"
        out = _drive(src, d / "a", snap_at=5)
        store = dst.MemmapRowStore(str(d / "b"), ROWS, SHAPES)
        store.restore_snapshot(str(d / "a" / "snap"), out["meta"])
        for n in SHAPES:
            np.testing.assert_array_equal(store.read_full(n),
                                          out["full"][n])
            np.testing.assert_array_equal(store._crc[n], out["crc"][n])
        store.close()


# -- the directory, the prefetcher, the host tier ----------------------------

def test_row_directory_state_matches_jax():
    def run(pkg):
        d = pkg.RowDirectory(10, compact_after=3)
        log = []
        for cid in (5, 2, 9, 7):
            log.append(d.allocate(cid))
        log.append(d.retire(2))
        log.append(d.retire(9))
        log.append(d.holes())
        log.append(d.flush_pending())
        for cid in (11, 12, 13):
            log.append(d.allocate(cid))
        log.append(d.translate(np.array([5, 7, 12])).tolist())
        with pytest.raises(KeyError):
            d.translate(np.array([2]))
        log.append(d.client_ids())
        st = d.state()
        d2 = pkg.RowDirectory(10)
        d2.load_state(st)
        log.append(d2.state())
        return log, st
    assert run(ths) == run(jhs)


def test_prefetcher_sequence_matches_jax():
    def run(pkg):
        gathered = []

        def gather(ids):
            gathered.append(np.asarray(ids).tolist())
            return len(gathered)

        pf = pkg.CohortPrefetcher(gather, enabled=True)
        log = []
        for prefetch, take in (([1, 2], [1, 2]), ([3, 4], [5, 6]),
                               (None, [7, 8]), ([9], [9]), ([1], None),
                               ([2], [2]), ([4], None)):
            if prefetch is not None:
                pf.prefetch(np.array(prefetch))
                pf.prefetch(np.array(prefetch))  # the same cohort again
            if take is not None:
                log.append(pf.take(np.array(take)))
        pf.invalidate()
        log.append((pf.counters(), gathered))
        off = pkg.CohortPrefetcher(gather, enabled=False)
        off.prefetch(np.array([1]))
        log.append((off.take(np.array([1])), off.counters()))
        return log
    assert run(ths) == run(jhs)


def test_prefetch_kill_switch(monkeypatch):
    monkeypatch.setenv("COMMEFFICIENT_COHORT_PREFETCH", "0")
    assert ths.prefetch_enabled() is jhs.prefetch_enabled() is False
    monkeypatch.delenv("COMMEFFICIENT_COHORT_PREFETCH")
    assert ths.prefetch_enabled() is jhs.prefetch_enabled() is True


def test_row_streamer_matches_disk_tier(tmp_path):
    """The host tier's gathers and slot-order adds give the rows the disk
    tier gives (without a base row: the host tier holds full rows)."""
    shapes = {"velocities": SHAPES["velocities"], "errors": SHAPES["errors"]}
    deltas = _deltas(5)
    arrays = TCS(velocities=torch.zeros((ROWS,) + shapes["velocities"]),
                 errors=torch.zeros((ROWS,) + shapes["errors"]),
                 weights=None)
    host = ths.RowStreamer(arrays, "cpu", queue_bound=2)
    disk = ths.MemmapRowStore(str(tmp_path), ROWS, shapes)
    for r, ids in enumerate(COHORTS):
        outs = []
        for tier in (host, disk):
            s = tier.gather_async(np.asarray(ids)).get()
            old = {n: getattr(s.proxy, n).clone() for n in shapes}
            new = {n: old[n] + torch.from_numpy(deltas[r][n])
                   for n in shapes}
            tier.scatter(s, TCS(weights=None, **old),
                         TCS(weights=None, **new))
            outs.append(old)
        for n in shapes:
            assert torch.equal(outs[0][n], outs[1][n])
    host.drain()
    for n in shapes:
        np.testing.assert_array_equal(host.arrays[n].numpy(),
                                      disk.read_full(n))
    assert host.close()["error"] is None and disk.close()["error"] is None


def test_row_streamer_surfaces_worker_errors():
    arrays = TCS(velocities=None, errors=torch.zeros(4, 3), weights=None)
    host = ths.RowStreamer(arrays, "cpu")
    with pytest.raises(IndexError):
        host.gather(np.array([7]))   # out of range, raised on the worker
    s = host.gather(np.array([1]))
    host.scatter(s, TCS(None, s.proxy.errors, None),
                 TCS(None, torch.ones(2, 3), None))  # wrong row count
    with pytest.raises(Exception):
        host.drain()
    assert host.close()["error"] is None


def test_offpath_fetches_not_counted():
    seen = []

    def worker():
        with offpath_fetches():
            seen.append(materialize(torch.ones(3)))

    with host_sync_monitor() as c:
        th = threading.Thread(target=worker)
        th.start()
        th.join()
        materialize(torch.zeros(2))
    assert len(seen) == 1 and c.count == 1


def test_snapshot_follows_written_rows_without_extents(tmp_path,
                                                       monkeypatch):
    """On a filesystem that cannot report holes the snapshot, its restore,
    the run state's discovery check and the lift to a full array read only
    the rows the store wrote (its ledger, then the snapshot's CRC
    sidecar), and give JAX's bytes and CRCs: the file's own extents are
    never asked for."""
    from commefficient_torch.federated import checkpoint as tck

    j = _drive(jhs, tmp_path / "j", rounds=2, snap_at=1)

    def no_extents(fd, size):
        raise AssertionError("the filesystem's extents were read")

    monkeypatch.setattr(ths, "_data_extents", no_extents)
    t = _drive(ths, tmp_path / "t", rounds=2, snap_at=1)
    _same(t, j)
    snap = str(tmp_path / "t" / "snap")
    store = ths.MemmapRowStore(str(tmp_path / "r"), ROWS, SHAPES)
    store.restore_snapshot(snap, t["meta"])
    for n in SHAPES:
        np.testing.assert_array_equal(store.read_full(n), t["full"][n])
        np.testing.assert_array_equal(
            ths.read_snapshot_member(snap, t["meta"], n), t["full"][n])
        # the rows read back: the ones the two rounds wrote
        assert set(np.flatnonzero(store._written[n])) <= \
            set(sum(COHORTS[:2], []))
    store.close()
    tck._verify_row_snapshot(str(tmp_path / "t" / "x.npz"),
                             {"client_store": dict(t["meta"],
                                                   dir="snap")})
    assert ths._row_extents(np.array([0, 1, 1, 0, 1], bool), 10, 45) == \
        [(10, 30), (40, 45)]


def test_ordered_workers_under_thread_pressure(tmp_path):
    """More stores than cores, each driven from its own thread through the
    prefetcher (take, scatter, prefetch the next cohort, as the engine
    orders them) with a short switch interval: every store's rows equal
    the same deltas added one after the other in numpy, so no gather
    overtakes an earlier scatter."""
    import sys

    n_threads = min((os.cpu_count() or 2) + 2, 16)
    shape, rows, rounds = (4, 16), 10, 30
    results, errors = {}, []

    def drive(k):
        try:
            rng = np.random.RandomState(k)
            cohorts = [rng.choice(rows, 4, replace=False)
                       for _ in range(rounds + 1)]
            deltas = rng.randn(rounds, 4, *shape).astype(np.float32)
            if k % 2:
                tier = ths.RowStreamer(
                    TCS(None, torch.zeros((rows,) + shape), None), "cpu",
                    queue_bound=2)
            else:
                tier = ths.MemmapRowStore(str(tmp_path / f"s{k}"), rows,
                                          {"errors": shape}, queue_bound=2)
            pf = ths.CohortPrefetcher(tier.gather_async, enabled=True)
            ref = np.zeros((rows,) + shape, np.float32)
            for t in range(rounds):
                s, _ = pf.take(cohorts[t])
                old = s.proxy.errors.clone()
                np.testing.assert_array_equal(old.numpy(),
                                              ref[cohorts[t]])
                new = old + torch.from_numpy(deltas[t])
                tier.scatter(s, TCS(None, old, None), TCS(None, new, None))
                for slot, r in enumerate(cohorts[t]):
                    ref[r] += (new - old).numpy()[slot]
                pf.prefetch(cohorts[t + 1])
            tier.drain()
            got = (tier.arrays["errors"].numpy() if k % 2
                   else tier.read_full("errors"))
            results[k] = (got.copy(), ref)
            assert tier.close()["error"] is None
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append((k, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(results) == n_threads
    for got, ref in results.values():
        np.testing.assert_array_equal(got, ref)
