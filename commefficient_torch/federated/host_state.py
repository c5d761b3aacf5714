"""Per-client state off the card: stream W participating rows per round.
The port of ``commefficient_tpu/federated/host_state.py``.

The reference keeps its ``(num_clients, ...)`` velocity and error arrays in
host shared memory and each round reads and writes only the W
participating rows (reference fed_aggregator.py:105-129). When the memory
plan (``federated/memory.py``) does not place the state on the card, the
round runs on a W-row proxy of it:

  rows  = gather(state[ids])        the W rows reach the card
  round = the unchanged round       on the W-row proxy, ids := arange(W)
  delta = new_proxy - rows          on the card
  state[ids] += delta               on the host, in slot order

Two tiers serve that contract, with one design:

- ``host``: ``RowStreamer`` keeps the rows in CPU float32 tensors
  (allocated with calloc semantics, so only rows a round touches become
  resident);
- ``disk``: ``MemmapRowStore`` keeps each state member in a SPARSE
  ``(num_rows, *row)`` float32 file (the JAX package's layout: a store
  written by one package reads in the other), so a 10^5-client population
  costs disk blocks only for rows ever touched.

In both, every gather and scatter runs on ONE worker thread per store, in
submission order: a gather enqueued after a scatter observes the
post-scatter rows, which is what makes ``CohortPrefetcher`` (a one-slot
lookahead that enqueues round t+1's gather while round t computes)
bit-transparent. The dispatch thread never waits on the device for it:

- a gather fills a pinned staging buffer on the worker and copies it to
  the card with ``non_blocking=True`` on an upload stream; the round's
  stream waits on the copy's event (a device-side wait), and the staging
  buffer rides the round's handle until the round is drained;
- a scatter computes ``new_proxy - old`` on the card right after the
  server step, copies it ``non_blocking`` into a pinned buffer on a
  download stream and records an event; the worker waits on that event
  (a completion wait, not a stream synchronization) and adds the rows on
  the host.

The worker runs inside ``profiling.offpath_fetches``, so the main thread's
``host_sync_monitor`` audits the dispatch path alone. On the CPU the same
code runs with CPU tensors and no events. The order of operations keeps
the arithmetic of the in-device scatter: the proxy's own ``index_add_``,
then ``new_proxy - old`` on the card, then a slot-order host add, so a
padded slot (client 0, delta +0.0) and a quarantined round (delta -0.0 on
the proxy) leave rows exactly as the ``hbm`` tier does.

The disk tier carries the JAX package's storage-fault plane whole: seeded
fault injection at the pread/pwrite seam (``IOFaultSchedule``,
``--inject_io_fault``), the retry/backoff/watchdog ladder, row
quarantine, the per-row CRC32 sidecar with scrub and repair from the last
``.rows`` snapshot, the bounded queue, and the checkpoint snapshots
(``save_snapshot`` / ``restore_snapshot`` / ``read_snapshot_member``).
``COMMEFFICIENT_COHORT_PREFETCH=0``, ``COMMEFFICIENT_IO_COALESCE=0`` and
``COMMEFFICIENT_IO_CHECKSUMS=0`` are the JAX package's kill switches.
One difference from the JAX package: the snapshot copy, its restore, the
``--resume auto`` check and ``read_snapshot_member`` read the rows the
store records as written (a ledger set before every row write, and a
snapshot's per-row CRC sidecar), not the file's extents. The logical
bytes and the CRCs are the JAX package's; the cost follows the rows
written even on a filesystem that cannot report holes (``SEEK_HOLE``
answering the end of the file, or ``EINVAL``), where the JAX package reads
the whole logical file. Without a sidecar the file's extents are read.
Bytes in a row the sidecar records as a zero row are not read: a restore
writes that row as the zero row it was.
``RowDirectory`` (the open-world id-to-row indirection) is ported and
held against the JAX package; nothing attaches it yet (the service plane
is ROADMAP queue 1 item 6e).
"""

from __future__ import annotations

import errno
import heapq
import json
import os
import queue
import sys
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.federated.rounds import ClientStates

__all__ = ["RowStreamer", "StreamedRound", "MemmapRowStore",
           "CohortPrefetcher", "prefetch_enabled", "read_snapshot_member",
           "IOFaultSchedule", "IOFaultInjector", "parse_io_fault",
           "StoreFatalError", "RowDirectory"]


class StreamedRound(NamedTuple):
    """One round's streaming context between its two phases: the original
    client ids (physical rows), the W-row proxy on the round's device, the
    event its upload recorded (None on the CPU) and the pinned staging
    buffers the upload read from."""

    ids: np.ndarray
    proxy: ClientStates
    ready: Optional[Any] = None
    staged: Tuple[Any, ...] = ()

    def wait_ready(self) -> None:
        """Make the calling thread's current stream wait for the upload (a
        device-side wait: nothing blocks the host), and tell the caching
        allocator the proxy is used on that stream."""
        if self.ready is None:
            return
        rows = [t for t in self.proxy if t is not None]
        stream = torch.cuda.current_stream(rows[0].device)
        stream.wait_event(self.ready)
        for t in rows:
            t.record_stream(stream)


class _Staged:
    """A delta on its way to the host: on the card, a pinned buffer that a
    non-blocking copy fills and the event recorded after it; on the CPU,
    the tensor itself."""

    def __init__(self, host: torch.Tensor, event=None):
        self.host = host
        self.event = event

    def wait(self) -> np.ndarray:
        """The delta's host bytes, after the copy has completed (a wait on
        the copy's event: not a stream synchronization)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _DeviceLink:
    """The transfers between host rows and the round's device: uploads on
    one side stream (the worker's), downloads on another (the dispatch
    thread's), so neither queues behind the round's kernels nor behind
    each other. No-ops on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device if device is not None else "cpu")
        self.cuda = self.device.type == "cuda"
        self.up = torch.cuda.Stream(self.device) if self.cuda else None
        self.down = torch.cuda.Stream(self.device) if self.cuda else None

    def staging(self, shape) -> torch.Tensor:
        """A host buffer for an upload: pinned on the card."""
        return torch.empty(tuple(shape), dtype=torch.float32,
                           pin_memory=self.cuda)

    def upload(self, host: torch.Tensor):
        """``host`` on the device: ``(tensor, event)``; the CPU tensor
        itself and None on the CPU."""
        if not self.cuda:
            return host, None
        with torch.cuda.stream(self.up):
            dev = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.up)
        return dev, ev

    def download(self, delta: torch.Tensor) -> _Staged:
        """Start the copy of a device delta to a pinned host buffer, after
        everything the dispatch thread has enqueued so far."""
        if not self.cuda:
            return _Staged(delta.contiguous())
        self.down.wait_stream(torch.cuda.current_stream(self.device))
        host = torch.empty(tuple(delta.shape), dtype=delta.dtype,
                           pin_memory=True)
        with torch.cuda.stream(self.down):
            host.copy_(delta, non_blocking=True)
            delta.record_stream(self.down)
            ev = torch.cuda.Event()
            ev.record(self.down)
        return _Staged(host, ev)


def _proxy_deltas(link: _DeviceLink, names, old_proxy: ClientStates,
                  new_proxy: ClientStates) -> Dict[str, _Staged]:
    """``new - old`` per member, on the round's device, on its way to the
    host."""
    out = {}
    for name in names:
        old = getattr(old_proxy, name)
        new = getattr(new_proxy, name)
        if old is None or new is None:
            continue
        out[name] = link.download(new - old)
    return out


class RowStreamer:
    """The ``host`` tier: the client rows in CPU float32 tensors
    (``states``), gathered and scattered on one ordered worker thread
    with the disk tier's contract (``gather_async`` / ``scatter`` /
    ``drain`` / ``close``). A gather selects the W rows into a pinned
    staging buffer and copies it to the card; a scatter adds the round's
    deltas back in slot order. A worker error surfaces at the next
    ``get()`` or ``drain()``; ``queue_bound`` applies backpressure."""

    def __init__(self, states: ClientStates, device, queue_bound: int = 16):
        self.arrays: Dict[str, torch.Tensor] = {
            name: getattr(states, name) for name in _MEMBERS
            if getattr(states, name) is not None}
        for name, arr in self.arrays.items():
            assert arr.device.type == "cpu" and arr.dtype == torch.float32, \
                (name, arr.device, arr.dtype)
        self.link = _DeviceLink(device)
        self.last_gather_ms = 0.0
        self.last_scatter_ms = 0.0
        self.gathers = 0
        self.scatters = 0
        self.queue_bound = int(queue_bound)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(self.queue_bound, 0))
        self._err: Optional[BaseException] = None
        self._busy_t_enq: Optional[float] = None
        self._closed = False
        self._fatal = None  # _PendingStream.get() audits it
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="row-stream-io")
        self._worker.start()

    @property
    def states(self) -> ClientStates:
        return ClientStates(**{m: self.arrays.get(m) for m in _MEMBERS})

    def _run(self):
        from commefficient_torch.profiling import offpath_fetches

        while True:
            item = self._q.get()
            if item is None:
                return
            kind, t_enq, payload = item
            self._busy_t_enq = t_enq
            try:
                with offpath_fetches():
                    self._run_one(kind, payload)
            except BaseException as e:  # surfaced by get() / drain()
                if kind == "gather":
                    payload[1]._set(err=e)
                self._err = e
            self._busy_t_enq = None

    def _run_one(self, kind, payload):
        if kind == "gather":
            ids, pending = payload
            t0 = time.perf_counter()
            idx = torch.from_numpy(ids)
            proxy, staged, ev = {}, [], None
            for name, arr in self.arrays.items():
                host = self.link.staging((len(ids),) + tuple(arr.shape[1:]))
                torch.index_select(arr, 0, idx, out=host)
                proxy[name], ev = self.link.upload(host)
                staged.append(host)
            self.last_gather_ms = (time.perf_counter() - t0) * 1e3
            self.gathers += 1
            pending._set(StreamedRound(
                ids=ids, proxy=ClientStates(**{m: proxy.get(m)
                                               for m in _MEMBERS}),
                ready=ev, staged=tuple(staged)))
        elif kind == "scatter":
            ids, deltas = payload
            t0 = time.perf_counter()
            for name, staged in deltas.items():
                d = torch.from_numpy(staged.wait())
                arr = self.arrays[name]
                # slot order: duplicate ids accumulate one after the other,
                # as the in-device index_add_ does
                for slot, row in enumerate(ids):
                    arr[int(row)].add_(d[slot])
            self.last_scatter_ms = (time.perf_counter() - t0) * 1e3
            self.scatters += 1
        else:  # "barrier"
            payload.set()

    def _put(self, item) -> None:
        assert not self._closed, "operation on a closed row streamer"
        self._q.put(item)

    def gather_async(self, ids) -> "_PendingStream":
        pending = _PendingStream(store=self)
        self._put(("gather", time.monotonic(),
                   (np.ascontiguousarray(np.asarray(ids, np.int64)),
                    pending)))
        return pending

    def gather(self, ids) -> StreamedRound:
        return self.gather_async(ids).get()

    def scatter(self, stream: StreamedRound, old_proxy: ClientStates,
                new_proxy: ClientStates) -> None:
        """Enqueue ``rows[ids] += new - old`` per member; the subtraction
        and its copy to the host are dispatched here, without a wait."""
        deltas = _proxy_deltas(self.link, self.arrays, old_proxy,
                               new_proxy)
        self._put(("scatter", time.monotonic(),
                   (np.asarray(stream.ids, np.int64), deltas)))

    def drain(self) -> None:
        """Barrier: every enqueued operation has completed; a worker error
        is raised here."""
        done = threading.Event()
        self._put(("barrier", time.monotonic(), done))
        done.wait()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self, timeout: float = 10.0) -> dict:
        """Drain, join the worker; never raises (the report carries an
        error), as ``MemmapRowStore.close``."""
        if self._closed:
            return {"joined": True, "pending": 0, "error": None}
        report: Dict[str, Any] = {"joined": True, "pending": 0,
                                  "error": None}
        try:
            self.drain()
        except BaseException as e:  # noqa: BLE001 — reported, not raised
            report["error"] = str(e)
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout)
        report["joined"] = not self._worker.is_alive()
        return report

    def load(self, states: ClientStates) -> None:
        """Replace the rows (a run-state restore), behind a drain."""
        self.drain()
        for name in self.arrays:
            arr = getattr(states, name)
            assert arr is not None and arr.shape == self.arrays[name].shape
            self.arrays[name] = arr.to("cpu", torch.float32).contiguous()

    def queue_depth(self) -> int:
        return self._q.qsize()

    def queue_age_ms(self) -> float:
        t = self._busy_t_enq
        return 0.0 if t is None else (time.monotonic() - t) * 1e3


# ---------------------------------------------------------------------------
# Disk tier: out-of-core client state behind the same gather/scatter contract
# ---------------------------------------------------------------------------

_MEMBERS = ("velocities", "errors", "weights")

_COPY_CHUNK = 1 << 23  # 8 MiB — bounds host RSS during snapshot copies


# -- CRC32 over sparse files without reading the holes ----------------------
#
# The snapshot CRC is defined over the LOGICAL content (holes read as
# zeros), so it is representation-independent — but computing it by
# read()ing a 10^6-row store would materialize terabytes of zero pages and
# make checkpoint cost scale with the population instead of the touched
# rows. CRC32 is linear over GF(2), so appending N zero BYTES to a stream
# is a closed-form operator (zlib's crc32_combine construction: apply
# x^(8N) mod the CRC polynomial via O(log N) 32x32 bit-matrix squarings),
# and the file's data extents (SEEK_DATA/SEEK_HOLE) tell us exactly where
# the zeros are without reading them.

_CRC_POLY = 0xEDB88320


def _gf2_times(mat, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat):
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(A || B) from crc32(A), crc32(B), len(B) — zlib's
    crc32_combine in pure Python (the C one is not exposed)."""
    if len2 <= 0:
        return crc1
    odd = [_CRC_POLY] + [1 << (n - 1) for n in range(1, 32)]
    even = _gf2_square(odd)
    odd = _gf2_square(even)
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def _crc32_zeros(crc: int, n: int) -> int:
    """Extend ``crc`` by ``n`` zero bytes in O(log^2 n) — the hole-skip
    operator (verified against ``zlib.crc32(b'\\0' * n)`` in
    tests/test_host_offload.py)."""
    if n <= 0:
        return crc
    block_crc = zlib.crc32(b"\x00")
    block_len = 1
    zeros_crc, zeros_len = 0, 0
    while n:
        if n & 1:
            zeros_crc = _crc32_combine(zeros_crc, block_crc, block_len)
            zeros_len += block_len
        n >>= 1
        if n:
            block_crc = _crc32_combine(block_crc, block_crc, block_len)
            block_len *= 2
    return _crc32_combine(crc, zeros_crc, zeros_len)


def _data_extents(fd: int, size: int):
    """Yield the file's (start, end) DATA extents in order via
    SEEK_DATA/SEEK_HOLE; one whole-file extent when the filesystem does
    not support extent queries (e.g. 9p test mounts) — the caller then
    degrades to a full read, exactly the pre-extent behavior."""
    try:
        os.lseek(fd, 0, os.SEEK_HOLE)  # support probe
    except (OSError, AttributeError):
        yield (0, size)
        return
    off = 0
    while off < size:
        try:
            data = os.lseek(fd, off, os.SEEK_DATA)
        except OSError:  # ENXIO — nothing but hole to EOF
            return
        hole = os.lseek(fd, data, os.SEEK_HOLE)
        yield (data, min(hole, size))
        off = hole


def _row_extents(rows: Optional[np.ndarray], nb: int, size: int):
    """The byte ranges of the rows set in ``rows`` (a bool per row), runs
    of adjacent rows merged; None (unknown) stays None."""
    if rows is None:
        return None
    idx = np.flatnonzero(rows)
    if not idx.size:
        return []
    cut = np.flatnonzero(np.diff(idx) != 1)
    starts = np.concatenate([idx[:1], idx[cut + 1]])
    ends = np.concatenate([idx[cut], idx[-1:]]) + 1
    return [(int(a) * nb, min(int(b) * nb, size))
            for a, b in zip(starts, ends)]


def _snapshot_rows(snap_dir: str, name: str,
                   nb: int) -> Optional[np.ndarray]:
    """The rows a snapshot member may hold data in, from its per-row CRC
    sidecar (a row whose recorded CRC is not a zero row's); None when the
    snapshot has no sidecar."""
    side = os.path.join(snap_dir, f"{name}.crc.npy")
    if not os.path.exists(side):
        return None
    return np.load(side) != np.uint32(_crc32_zeros(0, nb))


def _copy_sparse(src: str, dst: str, extents=None) -> int:
    """Stream-copy ``src`` to ``dst`` touching only DATA extents, writing
    holes for hole ranges AND for all-zero data chunks, so a 10^6-row
    store whose run touched W rows/round snapshots in O(touched rows)
    I/O — not O(logical size) — and the snapshot stays sparse. Returns
    the CRC32 of the LOGICAL content (hole ranges folded in via the
    closed-form zero-extension, so the CRC is representation-
    independent).

    ``extents``: the byte ranges that may hold data, where the caller
    knows them better than the filesystem (the row store's record of the
    rows it wrote, or a snapshot's CRC sidecar): a filesystem that cannot
    report holes (``SEEK_HOLE`` answering the end of the file, or
    ``EINVAL``) would otherwise be read whole."""
    crc = 0
    pos = 0
    size = os.path.getsize(src)
    with open(src, "rb") as s, open(dst, "wb") as d:
        for lo, hi in (extents if extents is not None
                       else _data_extents(s.fileno(), size)):
            crc = _crc32_zeros(crc, lo - pos)
            s.seek(lo)
            d.seek(lo)
            remaining = hi - lo
            while remaining > 0:
                buf = s.read(min(_COPY_CHUNK, remaining))
                if not buf:
                    break
                crc = zlib.crc32(buf, crc)
                if buf.count(0) == len(buf):
                    d.seek(len(buf), 1)  # hole — extend without writing
                else:
                    d.write(buf)
                remaining -= len(buf)
            pos = hi
        crc = _crc32_zeros(crc, size - pos)
        d.truncate(size)
    return crc


def _file_crc(path: str, extents=None) -> int:
    """Logical-content CRC32 of a (possibly sparse) file, reading only
    its data extents (or ``extents``) — see ``_copy_sparse``."""
    crc = 0
    pos = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        for lo, hi in (extents if extents is not None
                       else _data_extents(f.fileno(), size)):
            crc = _crc32_zeros(crc, lo - pos)
            f.seek(lo)
            remaining = hi - lo
            while remaining > 0:
                buf = f.read(min(_COPY_CHUNK, remaining))
                if not buf:
                    break
                crc = zlib.crc32(buf, crc)
                remaining -= len(buf)
            pos = hi
        crc = _crc32_zeros(crc, size - pos)
    return crc


# ---------------------------------------------------------------------------
# Storage-fault tolerance: seeded I/O fault injection + the retry/backoff/
# watchdog ladder (docs/fault_tolerance.md §storage faults)
# ---------------------------------------------------------------------------


class StoreFatalError(RuntimeError):
    """The terminal rung of the storage-fault ladder: the whole row store
    is unusable (a watchdog-declared hang, or a quarantine re-init that
    itself failed persistently). Raised ONCE with an actionable message;
    every later store operation re-raises it — recovery is a resume from
    the last checkpoint, not a retry."""


class _RowOpExhausted(Exception):
    """One row op failed every attempt of its retry ladder (internal —
    the caller degrades to row quarantine or escalates to fatal)."""

    def __init__(self, last: BaseException):
        super().__init__(str(last))
        self.last = last


@dataclass(frozen=True)
class IOFaultSchedule:
    """Seeded storage-fault schedule (``--inject_io_fault``) — the
    disk-tier sibling of the client plane's ``FaultSchedule``
    (federated/participation.py) and the device plane's
    ``--inject_fault``.

    Each raw row I/O operation on the store's ordered worker draws one
    uniform; the thresholds partition [0, 1): u < eio → a transient
    ``EIO``; u < eio+short → a short read (fewer bytes than requested);
    u < eio+short+torn → a torn write (half the bytes land, then the op
    errors — the retryable-visible form); the next two kinds are the
    SILENT faults PR 14 could not represent, the ones only per-row
    checksums can see (docs/fault_tolerance.md §silent corruption):
    ``flip`` corrupts one byte of the op's payload and the op SUCCEEDS
    (on writes the corruption lands on disk; on reads it lands in the
    returned buffer — the bit-rot vs bad-transfer pair), and ``storn``
    is the silently-torn write (half the bytes land and the op reports
    success; remapped to flip on reads, which have no silent-partial
    form). Then u < …+stall → the op stalls ``stall_ms`` before
    proceeding (a stall below the watchdog deadline is pure latency;
    above it, the watchdog declares the store hung). ``persist_after``
    is the row-quarantine threshold: a row accumulating that many
    CONSECUTIVE failed attempts is re-initialized from the ``init_rows``
    base (mirroring the client plane's ``quarantine_after``). ``seed``
    makes the whole schedule deterministic under rerun — ops execute in
    submission order on ONE worker thread, so the draw sequence is a
    pure function of the config (the byte a flip corrupts derives from
    the flip count + row index, NOT an extra RNG draw, so the one-draw-
    per-op stream is untouched). An all-zero schedule is legal on
    purpose: it is the "injection compiled in but idle" overhead probe
    the bench leg measures."""

    eio: float = 0.0
    short: float = 0.0
    torn: float = 0.0
    stall: float = 0.0
    flip: float = 0.0
    storn: float = 0.0
    stall_ms: float = 50.0
    seed: int = 0
    persist_after: int = 3

    @property
    def active(self) -> bool:
        return bool(self.eio or self.short or self.torn or self.stall
                    or self.flip or self.storn)

    def spec(self) -> str:
        return (f"eio={self.eio:g},short={self.short:g},"
                f"torn={self.torn:g},stall={self.stall:g},"
                f"flip={self.flip:g},storn={self.storn:g},"
                f"stall_ms={self.stall_ms:g},seed={self.seed},"
                f"persist_after={self.persist_after}")


def parse_io_fault(spec: str) -> IOFaultSchedule:
    """``--inject_io_fault`` grammar → IOFaultSchedule.

    ``'eio=P,short=P,torn=P,stall=P,flip=P,storn=P,stall_ms=N,seed=N,
    persist_after=N'`` — every key optional; probability mass must leave
    room for healthy ops (sum < 1). Fails at parse time with the
    offending entry named, like the sibling fault grammars."""
    fields: Dict[str, Any] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            key, val = (x.strip() for x in part.split("="))
        except ValueError:
            raise ValueError(
                f"--inject_io_fault: bad entry {part!r}; expected "
                f"KEY=VALUE with KEY in eio|short|torn|stall|flip|storn|"
                f"stall_ms|seed|persist_after") from None
        if key in ("eio", "short", "torn", "stall", "flip", "storn"):
            p = float(val)
            assert 0.0 <= p <= 1.0, (
                f"--inject_io_fault: {key}={val} must be in [0, 1]")
            fields[key] = p
        elif key == "stall_ms":
            ms = float(val)
            assert ms > 0, f"--inject_io_fault: stall_ms={val} must be > 0"
            fields[key] = ms
        elif key in ("seed", "persist_after"):
            fields[key] = int(val)
        else:
            raise ValueError(
                f"--inject_io_fault: unknown key {key!r}; use "
                f"eio|short|torn|stall|flip|storn|stall_ms|seed|"
                f"persist_after")
    sched = IOFaultSchedule(**fields)
    assert (sched.eio + sched.short + sched.torn + sched.stall
            + sched.flip + sched.storn) <= 1.0, (
        "--inject_io_fault: eio+short+torn+stall+flip+storn must be <= 1")
    assert sched.persist_after >= 1, (
        "--inject_io_fault: persist_after must be >= 1")
    return sched


class IOFaultInjector:
    """The seeded draw stream at the row-store I/O seam: ONE uniform per
    raw row operation, consumed on the ordered worker thread — so the
    injected schedule is deterministic for a fixed config and captured
    by checkpoints (``save_run_state``'s ``io/*`` keys carry the
    RandomState, like the client-fault RNG's ``part/*`` keys)."""

    def __init__(self, schedule: IOFaultSchedule):
        self.schedule = schedule
        self.rng = np.random.RandomState(schedule.seed)
        self.injected = {"eio": 0, "short": 0, "torn": 0, "stall": 0,
                         "flip": 0, "storn": 0}

    def draw(self) -> Optional[str]:
        s = self.schedule
        if not s.active:
            # idle injection still pays the seam (the bench overhead
            # probe) but not a draw per op — the RNG stream stays empty
            # so enabling a real schedule later starts it at the seed
            return None
        u = float(self.rng.random_sample())
        acc = 0.0
        for kind in ("eio", "short", "torn", "stall", "flip", "storn"):
            acc += getattr(s, kind)
            if u < acc:
                self.injected[kind] += 1
                return kind
        return None

    def flip_pos(self, row: int, nbytes: int) -> int:
        """The byte offset a drawn flip corrupts: a pure function of the
        flip count + row index (Knuth multiplicative hash), NOT an extra
        RNG draw — the one-draw-per-op stream stays a pure function of
        the schedule, and the checkpointed RNG state alone replays the
        corruption pattern."""
        return (int(row) * 2654435761 + self.injected["flip"] * 131) \
            % max(nbytes, 1)


class _PendingStream:
    """A gather in flight on the store's worker thread. ``get()`` blocks
    the CALLING thread on a threading.Event — a thread join, not a device
    fetch, so it is invisible to ``host_sync_monitor`` (the device proxy
    upload happens inside the worker)."""

    def __init__(self, store=None):
        self._done = threading.Event()
        self._value: Optional[StreamedRound] = None
        self._err: Optional[BaseException] = None
        self._store = store  # fatal-flag source for the get() wait
        self.io_ms: float = 0.0  # worker-measured read+upload duration

    def _set(self, value=None, err=None):
        # first writer wins: the watchdog may have already failed this
        # handle while the worker was stuck — the late completion (or the
        # worker's own error path) must not overwrite the surfaced timeout
        if self._done.is_set():
            return
        self._value, self._err = value, err
        self._done.set()

    def get(self) -> StreamedRound:
        # audit the store's fatal flag while waiting: the watchdog fails
        # the handle of the gather it can SEE (_cur_pending), but a hang
        # inside a SCATTER — which has no handle — must still unblock a
        # waiter queued behind it, or the dispatch thread wedges forever
        # in take() with the store already declared dead
        while not self._done.wait(0.1):
            if self._store is not None \
                    and self._store._fatal is not None:
                raise self._store._fatal
        if self._err is not None:
            raise self._err
        return self._value


class RowDirectory:
    """Client-id → physical-row indirection for an open-world population
    (docs/service.md): rows are ALLOCATED when a client registers,
    RETIRED into reusable holes when it departs, and the backing file is
    COMPACTED (live rows packed down, holes punched above) at checkpoint
    boundaries once enough holes accumulate.

    Lifecycle safety is split in two phases because scatters for
    in-flight rounds are not yet enqueued when a departure is drawn:
    ``retire`` only removes the mapping (the sampler never draws the
    client again, so its row goes cold), and the physical zero-write +
    hole reuse happen at the next DRAIN BARRIER (``flush_pending`` via
    ``MemmapRowStore.flush_retired``, called after the engine has
    drained) — a straggler's scatter therefore always lands on its
    original row before that row can be zeroed or handed to a joiner.

    Without a directory attached the store translates ids 1:1 (churn
    off = the exact pre-lifecycle path, bit-identical by construction —
    docs/parity_matrix.md row A22).
    """

    def __init__(self, capacity: int, compact_after: int = 0):
        self.capacity = int(capacity)
        # auto-compaction threshold in reusable holes (0 = only explicit
        # compact() calls); checked by MemmapRowStore.maybe_compact at
        # checkpoint-save boundaries
        self.compact_after = int(compact_after)
        self._row_of: Dict[int, int] = {}
        self._free: list = []     # zeroed holes, reusable (lowest first)
        self._pending: list = []  # retired rows awaiting the drain barrier
        self._high = 0            # rows ever handed out (high-water mark)
        self.allocated_total = 0
        self.retired_total = 0
        self.compactions = 0

    @property
    def live_count(self) -> int:
        return len(self._row_of)

    def holes(self) -> int:
        """Reusable + pending-retire holes (the compaction trigger)."""
        return len(self._free) + len(self._pending)

    def row_of(self, cid: int) -> int:
        return self._row_of[int(cid)]

    def client_ids(self) -> list:
        """Sorted client ids that currently own a row (the restore-time
        cross-check against the population masks)."""
        return sorted(self._row_of)

    def translate(self, ids: np.ndarray) -> np.ndarray:
        """Map a cohort's client ids to physical rows (the gather/scatter
        seam). A departed or never-registered id here is an upstream
        sampling bug — fail loudly, never read someone else's row."""
        try:
            return np.fromiter((self._row_of[int(c)] for c in ids),
                               np.int64, count=len(ids))
        except KeyError as e:
            raise KeyError(
                f"client {e.args[0]} has no allocated row — sampled "
                f"while departed/unregistered?") from None

    def allocate(self, cid: int) -> int:
        cid = int(cid)
        assert cid not in self._row_of, f"client {cid} already has a row"
        if self._free:
            row = heapq.heappop(self._free)
        else:
            row = self._high
            assert row < self.capacity, (
                f"row store full: {self.capacity} rows allocated and no "
                f"reusable holes (compaction pending?)")
            self._high += 1
        self._row_of[cid] = row
        self.allocated_total += 1
        return row

    def retire(self, cid: int) -> int:
        row = self._row_of.pop(int(cid))
        self._pending.append(row)
        self.retired_total += 1
        return row

    def flush_pending(self) -> list:
        """Hand the pending-retire rows over for zeroing and make them
        reusable. ONLY call behind a drain barrier (see class docstring);
        ``MemmapRowStore.flush_retired`` owns that contract."""
        rows, self._pending = self._pending, []
        for row in rows:
            heapq.heappush(self._free, row)
        return rows

    def state(self) -> dict:
        """JSON-able state riding the row-store snapshot's meta blob
        (``checkpoint.save_run_state`` → ``meta_json['client_store']``)."""
        return {"capacity": self.capacity,
                "compact_after": self.compact_after,
                "rows": {str(c): int(r) for c, r in self._row_of.items()},
                "free": [int(r) for r in self._free],
                "pending": [int(r) for r in self._pending],
                "high": int(self._high),
                "allocated_total": int(self.allocated_total),
                "retired_total": int(self.retired_total),
                "compactions": int(self.compactions)}

    def load_state(self, state: dict) -> None:
        assert int(state["capacity"]) == self.capacity, (
            f"checkpoint directory capacity {state['capacity']} != this "
            f"run's {self.capacity} — different client population?")
        self._row_of = {int(c): int(r)
                        for c, r in state["rows"].items()}
        self._free = [int(r) for r in state["free"]]
        heapq.heapify(self._free)
        self._pending = [int(r) for r in state["pending"]]
        self._high = int(state["high"])
        self.allocated_total = int(state["allocated_total"])
        self.retired_total = int(state["retired_total"])
        self.compactions = int(state["compactions"])


class MemmapRowStore:
    """Out-of-core ``(num_clients, *row)`` client state: one sparse
    memory-mapped-style row file per allocated state member, with the
    RowStreamer's ``gather(ids) → W-row device proxy`` /
    ``scatter(ids, delta)`` contract. The aggregator drives it exactly
    like the device/host-tier streamer; only the backing medium differs.

    Row access is POSITIONAL file I/O (``os.pread``/``os.pwrite`` at
    ``id × row_bytes``), not a live ``np.memmap`` view: mmap page-fault
    semantics are exactly right on a local ext4/xfs, but virtualized
    test filesystems (the 9p mounts CI runs on) fault in the ENTIRE
    mapping on first access — materializing the population is the one
    thing this store exists to avoid, and pread of W rows is the same
    syscall count either way. The files themselves are still created
    sparse (ftruncate to the logical size — a hole, not a write), so
    disk blocks materialize only for rows ever scattered to.

    All file I/O runs on ONE worker thread processing operations in
    submission order — the ordering invariant the prefetcher relies on
    (a gather enqueued after a scatter observes the post-scatter rows,
    exactly like the jit data dependency orders the device tier). The
    main thread never performs a blocking device fetch on this path: the
    scatter's delta materialization happens on the worker, overlapped
    with the next round's device compute. Scatter is a per-slot
    read-modify-write in slot order, so duplicate worker slots
    accumulate exactly like the device tier's ``.at[ids].add``.

    ``init_rows`` carries a per-member base row added at gather time
    (physical files stay zero-initialized/sparse): because the scatter is
    add-of-deltas and rows are only ever read through gather, storing
    ``state - init_row`` is exact — this is how ``do_topk_down``'s
    init-weights tiling avoids an O(num_clients · d) write at startup.

    Checkpoint integration (``save_snapshot``/``restore_snapshot``):
    snapshots are sparse chunk copies of the backing files with logical-
    content CRCs recorded in the run-state's ``meta_json`` — see
    ``checkpoint.save_run_state``.

    Storage-fault tolerance (docs/fault_tolerance.md §storage faults):
    every row op runs a bounded retry ladder (``io_retries`` retries with
    exponential backoff + jitter — retried transient faults are invisible
    to the trajectory: the op's eventual bytes are identical); a watchdog
    thread enforces a per-op deadline (``io_deadline_ms``) so a pread
    hung on a wedged NFS/9p mount becomes an actionable timeout error
    instead of a silent forever-wedge; a row accumulating
    ``persist_after`` consecutive failed attempts is QUARANTINED —
    re-initialized to the zero/base representation (sketches are linear,
    so the lost EF carry is a counted, documented degradation, not a
    crash) and surfaced through ``pop_events`` as a ``row_quarantined``
    record. Only when the store is unusable (a watchdog-declared hang,
    or a quarantine re-init that itself fails persistently) does the
    ladder end in ``StoreFatalError`` — one actionable error naming the
    recovery path. ``--inject_io_fault`` (``IOFaultSchedule``) injects
    seeded transient EIO / short reads / torn writes / stalls at the raw
    op seam to drill exactly this ladder. The work queue is BOUNDED
    (``queue_bound``) so a slow disk applies backpressure to the
    dispatch path instead of accumulating unbounded pending scatter
    deltas in host RAM.

    Integrity plane (docs/fault_tolerance.md §silent corruption): with
    ``checksums`` on (the disk-tier default; ``--no_io_checksums`` /
    COMMEFFICIENT_IO_CHECKSUMS=0 disable), a per-(member, row) CRC32
    sidecar records every row write's INTENDED bytes and every row read
    (gather — incl. each row of a coalesced block — scatter RMW, scrub)
    verifies against it, so the one fault class the retry ladder cannot
    see — corruption that never errors (``flip``/``storn`` injection,
    real bit rot, a silently-lying tear) — becomes a DETECTED, counted
    event. Detection enters the repair ladder (``_handle_corrupt``):
    verifying re-read → bit-exact repair from the last CRC'd ``.rows``
    snapshot (clean rows only) → the existing quarantine rung. The
    verification path only reads, so checksums-on is bit-identical to
    checksums-off on a clean store. ``scrub_rows`` > 0 additionally
    verifies that many rows per round on the ordered worker (rolling
    cursor), so cold rows no cohort touches are audited too.
    """

    backend = "memmap"

    def __init__(self, store_dir: str, num_rows: int,
                 row_shapes: Dict[str, Tuple[int, ...]],
                 device=None,
                 init_rows: Optional[Dict[str, np.ndarray]] = None,
                 inject: Optional[IOFaultSchedule] = None,
                 io_retries: int = 3, io_backoff_ms: float = 5.0,
                 io_deadline_ms: float = 30000.0,
                 queue_bound: int = 16,
                 checksums: bool = True, scrub_rows: int = 0):
        assert row_shapes, "a row store with no members is a bug upstream"
        for name in row_shapes:
            assert name in _MEMBERS, f"unknown state member {name!r}"
        self.store_dir = store_dir
        self.num_rows = int(num_rows)
        self.row_shapes = {k: tuple(int(x) for x in v)
                           for k, v in row_shapes.items()}
        self.init_rows = {k: np.asarray(v, np.float32)
                          for k, v in (init_rows or {}).items()}
        os.makedirs(store_dir, exist_ok=True)
        self._fd: Dict[str, int] = {}
        self._row_nbytes: Dict[str, int] = {}
        for name, shape in self.row_shapes.items():
            path = self.member_path(name)
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            nbytes = self.num_rows * int(np.prod(shape)) * 4
            # ALWAYS truncate to zero first, then extend to the logical
            # size (a hole, not a write): a fresh run must start from
            # zero rows even when a previous run left same-sized backing
            # files in this directory — state, unlike the hbm/host tiers'
            # init_client_states zeros, would otherwise silently leak
            # across runs. A --resume restore rebuilds content AFTER
            # construction from the checkpoint's .rows snapshot
            # (restore_snapshot), so discarding here is always correct.
            os.ftruncate(fd, 0)
            os.ftruncate(fd, nbytes)
            self._fd[name] = fd
            self._row_nbytes[name] = int(np.prod(shape)) * 4
        # the W-row proxies go to the round's device (a client group's
        # ranks each hold every row: the port replicates client state)
        self.link = _DeviceLink(device)
        # rolling I/O stats (telemetry: the offload span reads these)
        self.last_gather_ms: float = 0.0
        self.last_scatter_ms: float = 0.0
        self.gathers = 0
        self.scatters = 0
        # ---- storage-fault plane (docs/fault_tolerance.md) ----
        self.inject = IOFaultInjector(inject) if inject is not None else None
        self.io_retries = int(io_retries)
        self.io_backoff_ms = float(io_backoff_ms)
        self.io_deadline_ms = float(io_deadline_ms)
        # row-quarantine threshold: the schedule's persist_after when a
        # schedule is armed (mirroring the client plane, whose
        # quarantine_after rides the fault spec), the same default
        # otherwise — real storage faults walk the identical ladder
        self.quarantine_after = (inject.persist_after
                                 if inject is not None else 3)
        self.io_retry_total = 0      # failed attempts that were retried
        self.io_error_total = 0      # ops that exhausted the ladder
        self.rows_quarantined = 0
        self.read_ops = 0            # raw pread calls (coalescing metric)
        self.coalesced_rows = 0      # rows served by multi-row preads
        # ---- integrity plane (docs/fault_tolerance.md §silent
        # corruption): one CRC32 per (member, row) in a sidecar array,
        # recorded over the INTENDED bytes of every row write and
        # verified on every row read (gather, scatter read-modify-write,
        # scrub) — a mismatch is a DETECTED silent fault. Rows start as
        # holes, so the sidecar initializes to the closed-form CRC of a
        # zero row. COMMEFFICIENT_IO_CHECKSUMS=0 is the no-restart
        # kill-switch beside the --no_io_checksums flag.
        self.checksums = bool(checksums) and os.environ.get(
            "COMMEFFICIENT_IO_CHECKSUMS", "1") != "0"
        self.scrub_rows = int(scrub_rows)
        self._zero_crc = {name: _crc32_zeros(0, nb)
                          for name, nb in self._row_nbytes.items()}
        self._crc: Optional[Dict[str, np.ndarray]] = (
            {name: np.full(self.num_rows, self._zero_crc[name], np.uint32)
             for name in self.row_shapes}
            if self.checksums else None)
        # the last CRC'd snapshot covering this store's rows, if any:
        # (dir, {member: per-row CRCs at snapshot time}) — the repair
        # source for corrupt rows NOT written since ("clean" rows repair
        # BIT-exactly from it; dirty or uncovered rows fall to the
        # quarantine rung). Set by save_snapshot/restore_snapshot. The
        # dirty ledger is one bool per (member, row) — a numpy array,
        # not a tuple set: at the 10^6-row population this is 1 MB per
        # member instead of ~100 MB of boxed tuples.
        self._snap: Optional[Tuple[str, Dict[str, np.ndarray]]] = None
        self._dirty: Dict[str, np.ndarray] = {
            name: np.zeros(self.num_rows, bool)
            for name in self.row_shapes}
        # rows that may hold data in the backing file (set before every
        # row write; None once unknown): the snapshot copy reads only
        # these, so its cost follows the rows written even where the
        # filesystem cannot report holes
        self._written: Dict[str, Optional[np.ndarray]] = {
            name: np.zeros(self.num_rows, bool)
            for name in self.row_shapes}
        self.rows_corrupt = 0        # detected checksum mismatches
        self.rows_repaired = 0       # … repaired (reread or snapshot)
        self.scrub_checked = 0       # rows the background scrub verified
        self.scrub_mismatch = 0      # … that failed verification
        self._scrub_cursor = 0
        self._row_fails: Dict[int, int] = {}  # consecutive failed attempts
        self._events: list = []      # row_quarantined records (pop_events)
        self._ev_lock = threading.Lock()
        # backoff jitter rides its OWN stream: the injector's draw
        # sequence must stay one-per-op (deterministic schedule), and
        # jitter only shapes latency, never data
        self._jitter_rng = np.random.RandomState(0xC0FFEE)
        self._coalesce = os.environ.get("COMMEFFICIENT_IO_COALESCE",
                                        "1") != "0"
        # optional id→row indirection (open-world churn, docs/service.md);
        # None = identity translation, the exact pre-lifecycle path
        self._directory: Optional[RowDirectory] = None
        self._fatal: Optional[BaseException] = None
        self._inflight = None        # (op, member, row, t0) under the raw op
        self._cur_pending: Optional[_PendingStream] = None
        self._busy_t_enq: Optional[float] = None
        self.close_report: Optional[dict] = None
        # the ordered I/O worker, behind a BOUNDED queue: a slow disk
        # applies backpressure to the dispatch path instead of
        # accumulating unbounded pending scatter deltas in host RAM
        self.queue_bound = int(queue_bound)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(self.queue_bound,
                                                         0))
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="row-store-io")
        self._closed = False
        self._worker.start()
        self._stop_watchdog = threading.Event()
        self._watchdog = None
        if self.io_deadline_ms > 0:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              daemon=True,
                                              name="row-store-watchdog")
            self._watchdog.start()

    def member_path(self, name: str) -> str:
        return os.path.join(self.store_dir, f"{name}.f32")

    # -- the worker ---------------------------------------------------------

    def _run(self):
        from commefficient_torch.profiling import offpath_fetches

        while True:
            item = self._q.get()
            if item is None:
                return
            kind, t_enq, payload = item
            self._busy_t_enq = t_enq
            if self._fatal is not None:
                # terminal rung reached: fail every queued op fast with
                # the ONE actionable error (barriers still release so
                # drain() can surface it instead of hanging)
                if kind == "gather":
                    payload[1]._set(err=self._fatal)
                elif kind == "barrier":
                    payload.set()
                self._busy_t_enq = None
                continue
            try:
                with offpath_fetches():
                    self._run_one(kind, payload)
            except BaseException as e:  # surfaced by the next get()/drain()
                if kind == "gather":
                    # BOTH channels: the pending handle (for a take() that
                    # consumes it) AND the store error slot — a prefetched
                    # gather whose cohort is later DISCARDED never has
                    # get() called, and its I/O failure must not vanish;
                    # drain() re-raising an already-surfaced error is the
                    # fail-loud side of that trade
                    payload[1]._set(err=e)
                    self._err = e
                else:
                    self._err = e
            # never leave a completed gather's handle as the watchdog's
            # unblock target — a later trip must not touch a dead handle
            self._cur_pending = None
            self._busy_t_enq = None

    # -- the raw I/O seam (fault injection lives HERE) -----------------------

    def _injected_stall(self):
        """Sleep the schedule's stall_ms in small increments, aborting the
        moment the watchdog declares the store dead — so a test-injected
        hang unwedges the worker once the deadline has done its job (a
        REAL hung syscall cannot be interrupted; there the worker stays
        stuck and only the watchdog's error surfaces)."""
        ms = self.inject.schedule.stall_ms
        t0 = time.monotonic()
        while (time.monotonic() - t0) * 1e3 < ms:
            if self._fatal is not None:
                raise self._fatal
            time.sleep(min(0.01, ms / 1e3))

    def _pread_block(self, name: str, row0: int, count: int) -> np.ndarray:
        """One raw (possibly multi-row) positional read, with the fault
        injector's per-op draw applied — THE read seam."""
        kind = self.inject.draw() if self.inject is not None else None
        if kind == "torn":
            # a torn WRITE has no read equivalent; the nearest read-side
            # fault is a partial transfer — remap instead of silently
            # no-opping, so every drawn (and counted) fault is exercised
            kind = "short"
        elif kind == "storn":
            # the silently-torn write has no silent-partial read form (a
            # short read is length-checked below, i.e. loud) — the read-
            # side silent equivalent is buffer corruption, same remap
            # rationale as torn->short
            kind = "flip"
        if kind == "stall":
            self._injected_stall()
        elif kind == "eio":
            raise OSError(errno.EIO,
                          f"injected EIO (read {name} row {row0})")
        nb = self._row_nbytes[name]
        want = nb * count
        self.read_ops += 1
        buf = os.pread(self._fd[name], want, row0 * nb)
        if kind == "short":
            buf = buf[: want // 2]
        if len(buf) != want:
            raise OSError(errno.EIO,
                          f"short read: {len(buf)}/{want} bytes "
                          f"({name} row {row0})")
        if kind == "flip":
            # SILENT read-side corruption (a bad transfer, not bad
            # media): one byte of the returned buffer flips and the op
            # reports success — only the per-row checksum can see it;
            # the handler's verifying re-read heals this form
            buf = bytearray(buf)
            buf[self.inject.flip_pos(row0, want)] ^= 0xA5
        return np.frombuffer(bytes(buf) if isinstance(buf, bytearray)
                             else buf, np.float32).reshape(
            (count,) + self.row_shapes[name]).copy()

    def _pwrite_row(self, name: str, row: int, values: np.ndarray) -> None:
        """One raw positional row write, with the fault injector's per-op
        draw applied — THE write seam. On every SUCCESSFUL write the
        per-row checksum sidecar records the CRC of the INTENDED bytes
        (computed before any injected corruption — that asymmetry is the
        whole detection mechanism: a flip/storn write leaves the medium
        disagreeing with the sidecar, exactly like real bit rot)."""
        kind = self.inject.draw() if self.inject is not None else None
        if kind == "short":
            # a short READ has no write equivalent; the nearest write-
            # side fault is the torn (partial) write — same remap
            # rationale as _pread_block's torn->short
            kind = "torn"
        if kind == "stall":
            self._injected_stall()
        elif kind == "eio":
            raise OSError(errno.EIO,
                          f"injected EIO (write {name} row {row})")
        nb = self._row_nbytes[name]
        data = np.ascontiguousarray(values, np.float32).tobytes()
        crc = zlib.crc32(data)
        if self._written[name] is not None:
            self._written[name][int(row)] = True
        if kind == "torn":
            # half the bytes land, then the op errors — the retryable-
            # VISIBLE torn write (the retry's full rewrite repairs this
            # one, docs/fault_tolerance.md)
            os.pwrite(self._fd[name], data[: len(data) // 2], row * nb)
            raise OSError(errno.EIO,
                          f"injected torn write ({name} row {row})")
        if kind == "storn":
            # the SILENT tear: half the bytes land and the op reports
            # success — the fault class PR 14 explicitly could not
            # represent; only the checksum mismatch on the next read
            # (or scrub) can see it
            os.pwrite(self._fd[name], data[: len(data) // 2], row * nb)
            self._note_write(name, row, crc)
            return
        if kind == "flip":
            # SILENT media corruption: one byte flips on its way to disk
            # and the op reports success (seeded bit rot)
            data = bytearray(data)
            data[self.inject.flip_pos(row, len(data))] ^= 0xA5
            data = bytes(data)
        n = os.pwrite(self._fd[name], data, row * nb)
        if n != len(data):
            raise OSError(errno.EIO,
                          f"short write: {n}/{len(data)} bytes "
                          f"({name} row {row})")
        self._note_write(name, row, crc)

    def _note_write(self, name: str, row: int, crc: int) -> None:
        """Record a successful row write in the checksum sidecar and the
        dirty-since-snapshot ledger (a dirty row can no longer repair
        from the snapshot — its true content has moved past it)."""
        if self._crc is not None:
            self._crc[name][int(row)] = crc
            self._dirty[name][int(row)] = True

    # -- the retry/backoff/quarantine ladder ---------------------------------

    def _laddered(self, op: str, name: str, row: Optional[int], fn):
        """Run one raw row op through the bounded retry ladder:
        ``io_retries`` retries with exponential backoff + jitter. The
        in-flight marker around each attempt is what the watchdog
        thread audits against ``io_deadline_ms``. Row-keyed ops track
        CONSECUTIVE failed attempts; a row past ``quarantine_after``
        (the schedule's persist_after) stops burning retries — the
        caller quarantines it. Raises ``_RowOpExhausted`` after the
        last attempt; re-raises ``StoreFatalError`` immediately (a
        dead store is never retried)."""
        last: Optional[BaseException] = None
        for attempt in range(self.io_retries + 1):
            if self._fatal is not None:
                raise self._fatal
            self._inflight = (op, name, row, time.monotonic())
            try:
                out = fn()
                self._inflight = None
                if row is not None:
                    self._row_fails.pop(row, None)
                return out
            except StoreFatalError:
                self._inflight = None
                raise
            except Exception as e:  # noqa: BLE001 — transient I/O fault
                self._inflight = None
                last = e
                if row is not None:
                    fails = self._row_fails.get(row, 0) + 1
                    self._row_fails[row] = fails
                    if fails >= self.quarantine_after:
                        break  # past the quarantine threshold: stop here
                if attempt < self.io_retries:
                    self.io_retry_total += 1
                    delay = (self.io_backoff_ms * (2 ** attempt)
                             * (0.5 + float(
                                 self._jitter_rng.random_sample())))
                    time.sleep(delay / 1e3)
        self.io_error_total += 1
        raise _RowOpExhausted(last)

    def _fatal_now(self, msg: str,
                   cause: Optional[BaseException] = None) -> StoreFatalError:
        err = StoreFatalError(
            f"row-store I/O failed persistently: {msg} "
            f"(store {self.store_dir}; {self.io_retry_total} retried "
            f"attempt(s), {self.io_error_total} exhausted op(s), "
            f"{self.rows_quarantined} row quarantine(s) this run). The "
            f"backing storage is unusable — fix it (or point --state_dir "
            f"at healthy storage) and resume from the last checkpoint "
            f"with --resume auto (docs/fault_tolerance.md §storage "
            f"faults).")
        if cause is not None:
            err.__cause__ = cause
        self._fatal = err
        self._err = err
        return err

    def _quarantine_row(self, row: int, op: str, cause: str) -> None:
        """Row-level graceful degradation, mirroring client quarantine
        (docs/fault_tolerance.md): re-initialize the failing row to the
        zero/base representation across ALL members (rows are only ever
        read as base + stored delta, so this is exactly ``init_rows``;
        the lost EF carry is a counted degradation — sketches are
        linear, training continues). Recorded for the dispatch thread to
        surface as a ``row_quarantined`` telemetry event. A re-init that
        ITSELF fails persistently is the terminal rung: the store is
        declared unusable with one actionable error."""
        for name in self._fd:
            zero = np.zeros(self.row_shapes[name], np.float32)
            try:
                self._laddered("quarantine-reinit", name, None,
                               lambda n=name: self._pwrite_row(n, row,
                                                               zero))
            except _RowOpExhausted as e:
                raise self._fatal_now(
                    f"quarantining row {row} failed — the re-init write "
                    f"of member {name!r} errored every attempt "
                    f"({e.last})", cause=e.last)
        self.rows_quarantined += 1
        self._row_fails.pop(row, None)
        with self._ev_lock:
            self._events.append({"kind": "row_quarantined",
                                 "row": int(row), "op": op,
                                 "cause": str(cause)[:200]})
        print(f"ROW STORE: quarantined row {row} after repeated {op} "
              f"failures ({cause}); re-initialized from the base row — "
              f"the row's EF carry is lost (counted degradation, "
              f"docs/fault_tolerance.md)", file=sys.stderr, flush=True)

    # -- the integrity plane: verify-on-read + repair ------------------------

    def _snapshot_row(self, name: str, row: int) -> Optional[np.ndarray]:
        """The row's BIT-exact content from the last CRC'd snapshot, or
        None when no snapshot covers it: none taken/restored yet, the row
        was written since (its true content moved past the snapshot), or
        the snapshot's own bytes fail their recorded CRC (the corruption
        predates the snapshot — it inherited the bad bytes)."""
        if self._snap is None or self._dirty[name][row]:
            return None
        snap_dir, crcs = self._snap
        if name not in crcs:
            return None
        nb = self._row_nbytes[name]
        try:
            with open(os.path.join(snap_dir, f"{name}.f32"), "rb") as f:
                f.seek(row * nb)
                buf = f.read(nb)
        except OSError:
            return None
        if len(buf) != nb or zlib.crc32(buf) != int(crcs[name][row]):
            return None
        return np.frombuffer(buf, np.float32).reshape(
            self.row_shapes[name]).copy()

    def _handle_corrupt(self, name: str, row: int, want: int,
                        where: str) -> np.ndarray:
        """A row read did not match its sidecar CRC — a DETECTED silent
        fault (docs/fault_tolerance.md §silent corruption). The repair
        ladder, least-lossy rung first:

        1. one verifying RE-READ — transfer corruption (a flipped buffer,
           not flipped media) heals itself: the bytes on disk were right
           all along;
        2. snapshot repair — a row NOT written since the last CRC'd
           ``.rows`` snapshot restores BIT-exactly from it (the write
           goes back through the laddered seam, re-recording the CRC);
        3. the existing quarantine rung owns unrepairable rows: base-row
           re-init, the counted EF-carry degradation.

        Every detection and its resolution surface as counted
        ``row_corrupt`` / ``row_repaired`` (or ``row_quarantined``)
        events popped to the dispatch thread."""
        self.rows_corrupt += 1
        cause = f"checksum mismatch ({where}: member {name!r} row {row})"
        with self._ev_lock:
            self._events.append({"kind": "row_corrupt", "row": int(row),
                                 "member": name, "where": where})
        print(f"ROW STORE: {cause} — silent corruption detected "
              f"(docs/fault_tolerance.md §silent corruption)",
              file=sys.stderr, flush=True)
        try:
            again = self._laddered(
                "reread", name, None,
                lambda: self._pread_block(name, row, 1))[0]
        except _RowOpExhausted:
            again = None
        if again is not None \
                and zlib.crc32(np.ascontiguousarray(again)) == want:
            self.rows_repaired += 1
            with self._ev_lock:
                self._events.append({"kind": "row_repaired",
                                     "row": int(row), "member": name,
                                     "source": "reread"})
            return again
        rep = self._snapshot_row(name, row)
        if rep is not None \
                and zlib.crc32(np.ascontiguousarray(rep)) == want:
            try:
                # the repair write runs the ladder DIRECTLY (not
                # _write_row, which swallows exhaustion into its own
                # quarantine): a repair is only a repair if its bytes
                # actually landed — otherwise fall through to the one
                # quarantine rung below, never count both
                self._laddered("write", name, row,
                               lambda: self._pwrite_row(name, row, rep))
            except _RowOpExhausted as e:
                self._quarantine_row(
                    row, where,
                    f"{cause}; snapshot repair write failed ({e.last})")
                return np.zeros(self.row_shapes[name], np.float32)
            # the repair restored exactly the snapshot's content — undo
            # the dirty marker the write just set, so a LATER corruption
            # of this row can still repair from the same snapshot
            self._dirty[name][row] = False
            self.rows_repaired += 1
            with self._ev_lock:
                self._events.append({"kind": "row_repaired",
                                     "row": int(row), "member": name,
                                     "source": "snapshot"})
            print(f"ROW STORE: row {row} member {name!r} repaired "
                  f"bit-exactly from the .rows snapshot",
                  file=sys.stderr, flush=True)
            return rep
        self._quarantine_row(row, where, cause)
        return np.zeros(self.row_shapes[name], np.float32)

    def _verify_row(self, name: str, row: int, values: np.ndarray,
                    where: str) -> np.ndarray:
        """Check one freshly read row against the sidecar; on mismatch,
        return whatever the repair ladder recovers instead."""
        if self._crc is None:
            return values
        row = int(row)
        want = int(self._crc[name][row])
        if zlib.crc32(np.ascontiguousarray(values)) == want:
            return values
        if where == "scrub":
            self.scrub_mismatch += 1
        return self._handle_corrupt(name, row, want, where)

    def _read_row(self, name: str, row: int,
                  where: str = "gather") -> np.ndarray:
        """One row through the full ladder: retries, then quarantine
        (the re-initialized row reads as zeros = the base
        representation), then — checksums on — CRC verification with
        the repair ladder behind it."""
        try:
            vals = self._laddered(
                "read", name, row,
                lambda: self._pread_block(name, row, 1))[0]
        except _RowOpExhausted as e:
            self._quarantine_row(row, where, str(e.last))
            return np.zeros(self.row_shapes[name], np.float32)
        return self._verify_row(name, row, vals, where)

    def _write_row(self, name: str, row: int, values: np.ndarray) -> None:
        """One row write through the full ladder. On quarantine the row
        was just reset to base — the in-flight value (pre-quarantine
        content + delta) is deliberately discarded with the rest of the
        row's EF state (the documented degradation)."""
        try:
            self._laddered("write", name, row,
                           lambda: self._pwrite_row(name, row, values))
        except _RowOpExhausted as e:
            self._quarantine_row(row, "write", str(e.last))

    def _gather_member(self, name: str, ids: np.ndarray,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
        """All of one member's cohort rows, with CONTIGUOUS id runs
        coalesced into single multi-row preads (the common contiguous-
        cohort case pays one syscall per run instead of one per row —
        bit-identical to the per-row path: the same bytes land at the
        same slots; COMMEFFICIENT_IO_COALESCE=0 restores per-row). A
        coalesced read that exhausts its retries degrades to the
        per-row path, which owns the row-level quarantine ladder. Every
        row of a coalesced block is CRC-verified individually, so a
        corrupt row inside a block repairs without re-reading its
        healthy neighbors."""
        if out is None:
            out = np.empty((len(ids),) + self.row_shapes[name], np.float32)
        i, n = 0, len(ids)
        while i < n:
            j = i + 1
            if self._coalesce:
                while j < n and int(ids[j]) == int(ids[j - 1]) + 1:
                    j += 1
            if j - i == 1:
                out[i] = self._read_row(name, int(ids[i]))
            else:
                row0, count = int(ids[i]), j - i
                try:
                    out[i:j] = self._laddered(
                        "read", name, None,
                        lambda: self._pread_block(name, row0, count))
                    self.coalesced_rows += count
                    if self._crc is not None:
                        for k in range(i, j):
                            out[k] = self._verify_row(
                                name, int(ids[k]), out[k], "gather")
                except _RowOpExhausted:
                    for k in range(i, j):
                        out[k] = self._read_row(name, int(ids[k]))
            i = j
        return out

    # -- the background scrubber --------------------------------------------

    def scrub_async(self) -> None:
        """Enqueue one scrub pass: the ordered worker verifies the next
        ``scrub_rows`` rows (rolling cursor over the whole population)
        against the checksum sidecar, so corruption in rows no cohort
        ever touches is still found — and repaired — before the next
        snapshot can inherit it. A no-op with scrubbing off, checksums
        off, or the store already dead (the scrub must never block a
        dying run's teardown)."""
        if (self.scrub_rows <= 0 or self._crc is None or self._closed
                or self._fatal is not None):
            return
        try:
            self._q.put_nowait(("scrub", time.monotonic(),
                                self.scrub_rows))
        except queue.Full:
            # a full queue means the disk is already behind — skipping a
            # scrub pass under backpressure is the right trade (the
            # cursor resumes where it left off next round)
            pass

    def _run_scrub(self, budget: int) -> None:
        for _ in range(min(int(budget), self.num_rows)):
            row = self._scrub_cursor
            self._scrub_cursor = (self._scrub_cursor + 1) % self.num_rows
            for name in self._fd:
                self._read_row(name, row, where="scrub")
            self.scrub_checked += 1

    # -- the watchdog --------------------------------------------------------

    def _watchdog_loop(self):
        """Audit the worker's in-flight raw op against the per-op
        deadline. A hung syscall cannot be cancelled from Python; what
        CAN be done — and what this does — is turn the silent forever-
        wedge into an observable failure: declare the store dead, fail
        the blocked gather handle so ``take()``/``drain()`` unblock with
        one actionable timeout error, and leave the stuck daemon worker
        behind (docs/fault_tolerance.md §storage faults)."""
        poll = min(max(self.io_deadline_ms / 4e3, 0.05), 1.0)
        while not self._stop_watchdog.wait(poll):
            if self._fatal is not None:
                continue
            info = self._inflight
            if info is None:
                continue
            op, name, row, t0 = info
            age_ms = (time.monotonic() - t0) * 1e3
            if age_ms <= self.io_deadline_ms:
                continue
            where = f"row {row}" if row is not None else "row block"
            err = self._fatal_now(
                f"watchdog deadline exceeded — {op} of {name!r} "
                f"{where} has been in flight {age_ms:.0f} ms "
                f"(--io_deadline_ms {self.io_deadline_ms:g}; queue "
                f"depth {self._q.qsize()}) — the filesystem under the "
                f"store is stalled or hung")
            pending = self._cur_pending
            if pending is not None:
                pending._set(err=err)
            print(f"ROW STORE WATCHDOG: {err}", file=sys.stderr,
                  flush=True)

    def _run_one(self, kind, payload):
        if kind == "gather":
            ids, pending = payload
            self._cur_pending = pending
            t0 = time.perf_counter()
            proxy, staged, ev = {}, [], None
            for name in self._fd:
                # read straight into the (pinned) staging buffer
                host = self.link.staging((len(ids),) + self.row_shapes[name])
                rows = self._gather_member(name, ids, out=host.numpy())
                base = self.init_rows.get(name)
                if base is not None:
                    np.add(rows, base, out=rows)
                proxy[name], ev = self.link.upload(host)
                staged.append(host)
            self.last_gather_ms = (time.perf_counter() - t0) * 1e3
            self.gathers += 1
            self._cur_pending = None
            pending._set(StreamedRound(
                ids=ids,
                proxy=ClientStates(**{m: proxy.get(m) for m in _MEMBERS}),
                ready=ev, staged=tuple(staged)))
        elif kind == "scatter":
            ids, deltas = payload
            t0 = time.perf_counter()
            for name, delta in deltas.items():
                # the ONE device fetch of the disk tier, on the worker: a
                # wait on the pinned copy's event, overlapping the next
                # round's compute (profiling.offpath_fetches)
                d = delta.wait()
                # per-slot read-modify-write IN SLOT ORDER: duplicate ids
                # accumulate sequentially, replaying `.at[ids].add`
                # (the read is CRC-verified too — a delta must never be
                # applied on top of silently corrupt bytes)
                for slot, row in enumerate(ids):
                    row = int(row)
                    self._write_row(
                        name, row,
                        self._read_row(name, row, "scatter") + d[slot])
            self.last_scatter_ms = (time.perf_counter() - t0) * 1e3
            self.scatters += 1
        elif kind == "retire":
            # zero retired physical rows so a later reuse starts a fresh
            # client from the base representation (rows store deltas off
            # init_rows — zero delta IS the fresh state). Rides the same
            # write ladder as a scatter; FIFO ordering after the barrier
            # flush_retired requires means every in-flight scatter to
            # these rows has already landed.
            for row in payload:
                row = int(row)
                for name in self._fd:
                    self._write_row(name, row,
                                    np.zeros(self.row_shapes[name],
                                             np.float32))
                self._row_fails.pop(row, None)
        elif kind == "scrub":
            self._run_scrub(payload)
        else:  # "barrier"
            payload.set()

    _err: Optional[BaseException] = None

    # -- storage-fault observability (docs/observability.md) -----------------

    @property
    def fatal_error(self) -> Optional[BaseException]:
        """The terminal rung's error, once declared (None while the store
        is usable)."""
        return self._fatal

    def io_counters(self) -> Dict[str, Any]:
        """Cumulative storage-fault counters — the aggregator deltas
        these into the per-round offload span, which is what the watch
        plane's ``io_retry``/``io_error`` rules observe."""
        return {"retries": self.io_retry_total,
                "errors": self.io_error_total,
                "quarantined": self.rows_quarantined,
                "read_ops": self.read_ops,
                "coalesced_rows": self.coalesced_rows,
                "corrupt": self.rows_corrupt,
                "repaired": self.rows_repaired,
                "scrub_checked": self.scrub_checked,
                "scrub_mismatch": self.scrub_mismatch,
                "injected": (dict(self.inject.injected)
                             if self.inject is not None else None)}

    def queue_depth(self) -> int:
        return self._q.qsize()

    def queue_age_ms(self) -> float:
        """Age of the operation the worker is currently serving (enqueue
        to now) — the observable 'how far behind is the disk' signal the
        ``worker_queue_age`` watch rule reads; 0 when idle."""
        t = self._busy_t_enq
        return 0.0 if t is None else (time.monotonic() - t) * 1e3

    def pop_events(self) -> list:
        """Drain the worker-side ``row_quarantined`` records (the
        dispatch thread turns them into telemetry events — the event log
        write must not happen on the I/O worker)."""
        with self._ev_lock:
            events, self._events = self._events, []
        return events

    def _check_fatal(self) -> None:
        if self._fatal is not None:
            raise self._fatal

    def _put(self, item, timeout: Optional[float] = None) -> None:
        """Bounded enqueue: blocks (backpressure) while the queue is
        full, but keeps auditing the fatal flag so a caller never waits
        forever behind a store already declared dead."""
        t0 = time.monotonic()
        while True:
            self._check_fatal()
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                if timeout is not None \
                        and time.monotonic() - t0 > timeout:
                    raise TimeoutError(
                        f"row-store queue full ({self._q.qsize()} ops) "
                        f"for {timeout:g}s — the I/O worker is not "
                        f"making progress") from None

    # -- the gather/scatter contract ---------------------------------------

    def gather_async(self, ids) -> _PendingStream:
        """Enqueue a W-row read; returns a handle whose ``get()`` yields
        the ``StreamedRound`` (row-sharded device proxy, original ids).
        Raises the store's terminal error immediately once the ladder
        has declared the store unusable."""
        assert not self._closed, "gather on a closed row store"
        self._check_fatal()
        ids = np.asarray(ids, np.int64)
        if self._directory is not None:
            # translate ONCE, on the dispatch thread: the StreamedRound
            # carries physical rows from here on, so the round's eventual
            # scatter(stream, ...) writes back to the same rows even if
            # the client departs (mapping removed) while it is in flight
            ids = self._directory.translate(ids)
        pending = _PendingStream(store=self)
        self._put(("gather", time.monotonic(), (ids, pending)))
        return pending

    def gather(self, ids) -> StreamedRound:
        return self.gather_async(ids).get()

    def scatter(self, stream: StreamedRound, old_proxy: ClientStates,
                new_proxy: ClientStates) -> None:
        """Enqueue the round's delta write-back: ``rows[ids] += new - old``
        per member (duplicate slot ids accumulate in slot order, matching
        the device tier's ``.at[ids].add``). The subtraction is dispatched
        on device HERE (async); the worker materializes and writes. A
        full work queue BLOCKS here (bounded backpressure) instead of
        growing an unbounded host-RAM backlog of pending deltas."""
        assert not self._closed, "scatter on a closed row store"
        self._check_fatal()
        deltas = _proxy_deltas(self.link, self._fd, old_proxy, new_proxy)
        self._put(("scatter", time.monotonic(),
                   (np.asarray(stream.ids, np.int64), deltas)))

    def drain(self, timeout: Optional[float] = None) -> None:
        """Barrier: wait for every enqueued gather/scatter to complete
        (checkpoint save points and run teardown). Re-raises a worker-side
        failure instead of letting it vanish with the thread; once the
        watchdog (or the quarantine ladder) has declared the store dead,
        the wait aborts with that one actionable error instead of
        blocking forever behind a hung worker. ``timeout`` bounds the
        wait (the shutdown path) — exceeded, it raises TimeoutError with
        the stuck queue depth."""
        done = threading.Event()
        self._put(("barrier", time.monotonic(), done), timeout=timeout)
        t0 = time.monotonic()
        while not done.wait(0.1):
            if self._fatal is not None:
                raise self._fatal
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"row-store drain timed out after {timeout:g}s with "
                    f"{self._q.qsize()} queued op(s) (current op age "
                    f"{self.queue_age_ms():.0f} ms)")
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self, timeout: float = 10.0) -> dict:
        """Shutdown hygiene: drain with a bounded wait, join the worker
        with a timeout, and REPORT any still-pending queue items or
        surfaced error instead of silently abandoning a daemon thread
        mid-write. Never raises — close runs on every exit path,
        including teardown after the terminal rung already surfaced its
        error (the report carries it for the caller's log). Returns the
        report dict (also kept as ``close_report``)."""
        if self._closed:
            return self.close_report or {"joined": True, "pending": 0,
                                         "error": None}
        report: Dict[str, Any] = {"joined": True, "pending": 0,
                                  "error": None}
        try:
            self.drain(timeout=timeout)
        except BaseException as e:  # noqa: BLE001 — reported, not raised
            report["error"] = str(e)
        self._closed = True
        self._stop_watchdog.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout)
        if self._worker.is_alive():
            report["joined"] = False
            report["pending"] = self._q.qsize()
            print(f"row store close: I/O worker did not exit within "
                  f"{timeout:g}s — abandoning it with "
                  f"{report['pending']} queued op(s)"
                  + (f" (surfaced error: {report['error']})"
                     if report["error"] else ""),
                  file=sys.stderr, flush=True)
        else:
            for fd in self._fd.values():
                os.close(fd)
            self._fd.clear()
            if report["error"]:
                print(f"row store close: worker joined with a surfaced "
                      f"error: {report['error']}",
                      file=sys.stderr, flush=True)
        self.close_report = report
        return report

    # -- row lifecycle (open-world population churn, docs/service.md) --------

    def attach_directory(self, directory: RowDirectory) -> None:
        """Arm id→row indirection. The attach layer runs right after
        FedModel construction — nothing has been gathered yet, so every
        subsequent op goes through the translation. Without this call the
        store translates 1:1 (churn off = the exact pre-lifecycle path)."""
        assert directory.capacity <= self.num_rows, (
            f"directory capacity {directory.capacity} exceeds the store's "
            f"{self.num_rows} allocated rows")
        self._directory = directory

    @property
    def directory(self) -> Optional[RowDirectory]:
        return self._directory

    def flush_retired(self) -> int:
        """Zero the pending-retired rows and make them reusable holes.
        ONLY call behind a drain barrier (checkpoint saves, compaction,
        teardown): scatters for in-flight rounds are not enqueued until
        those rounds finish, so a retired row may still receive its
        straggler's delta until the engine has drained. The zero-writes
        ride the ordered worker queue, so anything enqueued afterwards
        (a joiner reusing the hole) observes fresh zero rows."""
        d = self._directory
        if d is None or not d._pending:
            return 0
        rows = d.flush_pending()
        self._put(("retire", time.monotonic(), rows))
        with self._ev_lock:
            self._events.append({"kind": "rows_retired",
                                 "rows": len(rows)})
        return len(rows)

    def maybe_compact(self) -> Optional[dict]:
        """Compact when the directory's hole count has reached its
        ``compact_after`` threshold — called by ``save_run_state`` right
        before the snapshot copy, so compaction is checkpoint-coordinated
        by construction: the next ``.rows`` snapshot records the packed
        layout plus the updated directory, and a crash between the two
        is impossible (same drain-first save path)."""
        d = self._directory
        if d is None or d.compact_after <= 0 \
                or d.holes() < d.compact_after:
            return None
        return self.compact()

    def compact(self) -> dict:
        """Pack live rows down to ``[0, live)`` (ascending by physical
        row, so every move is downward and never overwrites an unmoved
        live row), punch the backing files back to holes above, and
        rebase the directory. Runs on the caller thread behind a full
        drain (the worker is idle); moves go through the laddered
        read/write path, so fault injection and CRC verification cover
        the rewrite too. The old-layout snapshot can no longer repair
        rows, so it is disarmed until the next checkpoint re-arms one."""
        d = self._directory
        assert d is not None, "compact() requires an attached RowDirectory"
        self.drain()
        d.flush_pending()  # the rewrite itself reclaims them — no zero-write
        reclaimed = len(d._free)
        live = sorted(d._row_of.items(), key=lambda kv: kv[1])
        mapping: Dict[int, int] = {}
        moved = 0
        for new_row, (cid, old_row) in enumerate(live):
            mapping[old_row] = new_row
            if old_row != new_row:
                # unconditional write: position new_row may hold a
                # retired row's stale bytes (retire zero-writes are
                # skipped when compaction will rewrite anyway)
                for name in self._fd:
                    self._write_row(
                        name, new_row,
                        self._read_row(name, old_row, "compact"))
                moved += 1
            d._row_of[cid] = new_row
        n = len(live)
        for name, fd in self._fd.items():
            nb = self._row_nbytes[name]
            os.ftruncate(fd, n * nb)
            os.ftruncate(fd, self.num_rows * nb)
            if self._written[name] is not None:
                self._written[name][n:] = False
            if self._crc is not None:
                self._crc[name][n:] = self._zero_crc[name]
        # consecutive-failure counts follow their rows; holes drop out
        self._row_fails = {mapping[r]: c for r, c in self._row_fails.items()
                           if r in mapping}
        self._snap = None
        for dirty in self._dirty.values():
            dirty[:] = False
        d._free = []
        d._high = n
        d.compactions += 1
        stats = {"live": n, "moved": moved, "holes_reclaimed": reclaimed}
        with self._ev_lock:
            self._events.append(dict(stats, kind="rows_compacted"))
        return stats

    # -- whole-array access (cross-tier checkpoint restore) -----------------

    def write_full(self, name: str, array: np.ndarray) -> None:
        """Overwrite one member from a full in-memory array (restoring an
        hbm/host-tier checkpoint into a disk-tier run). Subtracts the
        member's init row so the stored-delta representation is preserved."""
        if self._directory is not None:
            raise RuntimeError(
                "cross-tier restore into a store with an active client "
                "directory (--churn) is not supported — the full array "
                "is id-ordered but physical rows are directory-mapped")
        self.drain()
        base = self.init_rows.get(name)
        nb = self._row_nbytes[name]
        # a full rewrite invalidates any snapshot coverage: every row's
        # true content just moved past it (the checksum sidecar restarts
        # from the zero-row CRC and re-records per written row below)
        self._snap = None
        for d in self._dirty.values():
            d[:] = False
        if self._crc is not None:
            self._crc[name][:] = self._zero_crc[name]
        # truncate-and-reextend first so the file is all holes, then skip
        # all-zero chunks: a mostly-zero restore (never-sampled clients'
        # rows, or topk-down weights that equal the base) stays sparse
        # instead of materializing the full logical size
        os.ftruncate(self._fd[name], 0)
        os.ftruncate(self._fd[name], self.num_rows * nb)
        written = np.zeros(self.num_rows, bool)
        self._written[name] = written
        step = max(1, _COPY_CHUNK // max(nb, 1))
        for lo in range(0, self.num_rows, step):
            chunk = np.ascontiguousarray(array[lo:lo + step], np.float32)
            if base is not None:
                chunk = chunk - base
            if chunk.any():
                raw = chunk.tobytes()
                written[lo:lo + chunk.shape[0]] = True
                os.pwrite(self._fd[name], raw, lo * nb)
                if self._crc is not None:
                    for k in range(chunk.shape[0]):
                        self._crc[name][lo + k] = zlib.crc32(
                            raw[k * nb:(k + 1) * nb])

    def read_full(self, name: str) -> np.ndarray:
        """One member as a full in-memory array (restoring a disk-tier
        checkpoint into an hbm/host-tier run — caller's RAM must hold it;
        the clear failure there is the allocator's, not a silent wrong
        restore). Deliberately NOT CRC-verified: this is the raw-bytes
        view the bench bit-identity pins and the snapshot path use;
        verified access is the gather/scrub path."""
        self.drain()
        base = self.init_rows.get(name)
        nb = self._row_nbytes[name]
        shape = (self.num_rows,) + self.row_shapes[name]
        out = np.empty(shape, np.float32)
        flat = out.reshape(self.num_rows, -1)
        step = max(1, _COPY_CHUNK // max(nb, 1))
        for lo in range(0, self.num_rows, step):
            hi = min(lo + step, self.num_rows)
            buf = os.pread(self._fd[name], (hi - lo) * nb, lo * nb)
            flat[lo:hi] = np.frombuffer(buf, np.float32).reshape(
                hi - lo, -1)
        return out + base if base is not None else out

    # -- checkpoint snapshots ----------------------------------------------

    def save_snapshot(self, snap_dir: str) -> dict:
        """Copy the backing files (sparsely) into ``snap_dir`` and return
        the meta blob ``checkpoint.save_run_state`` embeds in meta_json:
        member shapes/dtypes + logical-content CRCs + init-row CRCs. The
        caller is responsible for the drain-before-save ordering (the
        aggregator's save path drains engine then store)."""
        self.drain()
        os.makedirs(snap_dir, exist_ok=True)
        members = {}
        for name in self._fd:
            nb = self._row_nbytes[name]
            crc = _copy_sparse(self.member_path(name),
                               os.path.join(snap_dir, f"{name}.f32"),
                               _row_extents(self._written[name], nb,
                                            self.num_rows * nb))
            members[name] = {"shape": list(self.row_shapes[name]),
                             "crc": int(crc)}
            base = self.init_rows.get(name)
            if base is not None:
                # rows are stored as deltas off this base (the topk-down
                # init-weights trick); a restore into a DIFFERENT process
                # must reproduce base + delta exactly, so the base rides
                # the snapshot
                np.save(os.path.join(snap_dir, f"init_{name}.npy"), base)
                members[name]["init"] = True
        meta = {"backend": self.backend, "rows": self.num_rows,
                "members": members}
        if self._directory is not None:
            # the id→row table is part of the rows' meaning: a snapshot
            # of packed/holed physical rows is unreadable without it
            meta["directory"] = self._directory.state()
        with open(os.path.join(snap_dir, "store.json"), "w") as f:
            json.dump(meta, f)
        if self._crc is not None:
            # the per-row checksum sidecar rides the snapshot: it is the
            # restore's sidecar AND this process's repair source — a
            # corrupt row not written since this snapshot repairs
            # bit-exactly from these files (the caller renames the dir
            # into place and reports the final name via snapshot_moved)
            crcs = {}
            for name in self._fd:
                np.save(os.path.join(snap_dir, f"{name}.crc.npy"),
                        self._crc[name])
                crcs[name] = self._crc[name].copy()
            self._snap = (snap_dir, crcs)
            for d in self._dirty.values():
                d[:] = False
        return meta

    def snapshot_moved(self, new_dir: str) -> None:
        """The checkpoint layer renamed the snapshot directory into its
        final ``.rows`` name (the tmp-dir + rename atomicity pattern) —
        re-point the repair source at the surviving path."""
        if self._snap is not None:
            self._snap = (new_dir, self._snap[1])

    def _recompute_crcs(self, name: str) -> np.ndarray:
        """Rebuild one member's per-row CRC sidecar from its backing
        file, touching only DATA extents (hole rows keep the closed-form
        zero-row CRC) — the fallback for restoring a pre-checksum
        snapshot that carries no ``.crc.npy`` sidecar."""
        nb = self._row_nbytes[name]
        out = np.full(self.num_rows, self._zero_crc[name], np.uint32)
        fd = self._fd[name]
        size = self.num_rows * nb
        for lo, hi in _data_extents(fd, size):
            r0 = lo // nb
            r1 = min(-(-hi // nb), self.num_rows)
            for row in range(r0, r1):
                out[row] = zlib.crc32(os.pread(fd, nb, row * nb))
        return out

    def restore_snapshot(self, snap_dir: str, meta: dict) -> None:
        """Copy a snapshot back over the live files, verifying each file's
        logical CRC against the checkpoint's record — a torn or bit-rotted
        row snapshot fails loudly like a torn .npz does."""
        self.drain()
        assert meta.get("backend") == self.backend, (
            f"checkpoint row store backend {meta.get('backend')!r} != "
            f"{self.backend!r}")
        assert int(meta["rows"]) == self.num_rows, (
            f"checkpoint row store has {meta['rows']} rows but this run "
            f"allocates {self.num_rows} — different client population?")
        saved = meta["members"]
        assert set(saved) == set(self._fd), (
            f"checkpoint row store members {sorted(saved)} != this "
            f"config's {sorted(self._fd)}")
        if self._directory is not None:
            if "directory" not in meta:
                raise RuntimeError(
                    "--churn resume from a checkpoint that carries no "
                    "client directory — was it written by a churn-off "
                    "run? Restart without --churn or from scratch.")
            self._directory.load_state(meta["directory"])
        elif "directory" in meta:
            raise RuntimeError(
                "checkpoint row store carries a client directory (the "
                "run that wrote it had --churn on) — resume with the "
                "same --churn spec so ids map to the right rows.")
        for name, m in saved.items():
            # geometry must match BEFORE any bytes move: a different row
            # shape with the same member set and row count would pass the
            # CRC (it checks snapshot integrity, not config match) and
            # then silently reinterpret misaligned bytes at this config's
            # stride — same contract as the hbm/host path's check_shape
            got = tuple(int(x) for x in m["shape"])
            assert got == self.row_shapes[name], (
                f"checkpoint row store geometry mismatch: {name} rows are "
                f"{got} but this run expects {self.row_shapes[name]} — "
                f"was the checkpoint written with a different "
                f"model/sketch geometry or --mode?")
        for name in self._fd:
            src = os.path.join(snap_dir, f"{name}.f32")
            if not os.path.exists(src):
                raise RuntimeError(
                    f"row-store snapshot missing {src}; the checkpoint's "
                    f".rows directory is incomplete — try an earlier "
                    f"run_state or --resume auto")
            # the rows the snapshot's sidecar records as written (a
            # snapshot without one is copied by the file's extents)
            nb = self._row_nbytes[name]
            rows = _snapshot_rows(snap_dir, name, nb)
            crc = _copy_sparse(src, self.member_path(name),
                               _row_extents(rows, nb, self.num_rows * nb))
            self._written[name] = rows
            if crc != int(saved[name]["crc"]):
                raise RuntimeError(
                    f"row-store snapshot corrupt ({src}): content CRC "
                    f"{crc:#010x} != recorded "
                    f"{int(saved[name]['crc']):#010x}; try an earlier "
                    f"run_state or --resume auto")
            if saved[name].get("init"):
                # the snapshot's base row wins over this process's own:
                # stored rows are deltas off the SAVING run's base
                self.init_rows[name] = np.load(
                    os.path.join(snap_dir, f"init_{name}.npy"))
            # _copy_sparse truncate-rewrote the file IN PLACE (same
            # inode), so the held fd keeps addressing the restored bytes
        if self._crc is not None:
            # rebuild the checksum sidecar from the snapshot's own (or,
            # for a pre-checksum snapshot, from the restored bytes) and
            # arm the snapshot as this process's repair source
            crcs = {}
            for name in self._fd:
                side = os.path.join(snap_dir, f"{name}.crc.npy")
                if os.path.exists(side):
                    self._crc[name] = np.load(side).astype(np.uint32)
                else:
                    self._crc[name] = self._recompute_crcs(name)
                crcs[name] = self._crc[name].copy()
            self._snap = (snap_dir, crcs)
            for d in self._dirty.values():
                d[:] = False


def read_snapshot_member(snap_dir: str, meta: dict,
                         name: str) -> np.ndarray:
    """Lift ONE member of a row-store snapshot to a full in-memory array —
    the disk-tier-checkpoint → hbm/host-tier-run restore path
    (``checkpoint.load_run_state``). Verifies the recorded CRC; the
    caller's RAM must hold the result, which is exactly the point of the
    tier change."""
    m = meta["members"][name]
    path = os.path.join(snap_dir, f"{name}.f32")
    nb = int(np.prod(m["shape"])) * 4
    crc = _file_crc(path, _row_extents(_snapshot_rows(snap_dir, name, nb),
                                       nb, int(meta["rows"]) * nb))
    if crc != int(m["crc"]):
        raise RuntimeError(
            f"row-store snapshot corrupt ({path}): content CRC "
            f"{crc:#010x} != recorded {int(m['crc']):#010x}; try an "
            f"earlier run_state or --resume auto")
    shape = (int(meta["rows"]),) + tuple(int(x) for x in m["shape"])
    arr = np.array(np.memmap(path, np.float32, mode="r", shape=shape))
    if m.get("init"):
        arr = arr + np.load(os.path.join(snap_dir, f"init_{name}.npy"))
    return arr


# ---------------------------------------------------------------------------
# Double-buffered cohort prefetch
# ---------------------------------------------------------------------------

def prefetch_enabled() -> bool:
    """The ``COMMEFFICIENT_COHORT_PREFETCH=0`` kill-switch (default ON)."""
    return os.environ.get("COMMEFFICIENT_COHORT_PREFETCH", "1") != "0"


class CohortPrefetcher:
    """One-slot lookahead cache over a row plane's gather.

    ``prefetch(ids)`` dispatches round t+1's row gather while round t
    computes (``engine.cohort_lookahead`` feeds it the peeked next batch);
    ``take(ids)`` hands the round its stream — a HIT consumes the slot, a
    MISS (ids differ, slot empty, or kill-switch) gathers on the spot,
    exactly the pre-prefetch behavior. Because the underlying gather is
    ordering-safe (jit data dependencies on the device tier, the ordered
    I/O worker on the disk tier), prefetch on/off is bit-transparent —
    pinned in tests/test_host_offload.py.
    """

    def __init__(self, gather_async: Callable[[Any], Any],
                 enabled: Optional[bool] = None):
        self._gather = gather_async
        self.enabled = prefetch_enabled() if enabled is None else enabled
        self._slot: Optional[Tuple[bytes, Any]] = None
        self.hits = 0
        self.misses = 0
        self.discarded = 0  # prefetched cohorts never consumed
        self.last_wait_ms = 0.0  # take()'s block on an in-flight prefetch

    @staticmethod
    def _key(ids) -> bytes:
        return np.ascontiguousarray(np.asarray(ids, np.int64)).tobytes()

    def prefetch(self, ids) -> None:
        if not self.enabled:
            return
        key = self._key(ids)
        if self._slot is not None:
            if self._slot[0] == key:
                return
            self.discarded += 1
        self._slot = (key, self._gather(ids))

    def take(self, ids):
        """The round's stream: prefetched if the slot matches, gathered now
        otherwise. Returns a resolved ``StreamedRound``; also reports
        whether this was a hit (the telemetry offload span records it)."""
        key = self._key(ids)
        t0 = time.perf_counter()
        if self._slot is not None and self._slot[0] == key:
            _, handle = self._slot
            self._slot = None
            self.hits += 1
            stream = handle.get() if isinstance(handle, _PendingStream) \
                else handle
            self.last_wait_ms = (time.perf_counter() - t0) * 1e3
            return stream, True
        if self._slot is not None:
            self.discarded += 1
            self._slot = None
        self.misses += 1
        handle = self._gather(ids)
        stream = handle.get() if isinstance(handle, _PendingStream) \
            else handle
        self.last_wait_ms = (time.perf_counter() - t0) * 1e3
        return stream, False

    def invalidate(self) -> None:
        """Drop a cached stream whose source rows are stale — called by
        the checkpoint restore (the snapshot copy-back rewrote the rows a
        prefetched cohort was gathered from)."""
        if self._slot is not None:
            self.discarded += 1
            self._slot = None

    def counters(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "discarded": self.discarded}
