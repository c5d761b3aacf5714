"""Per-op device profile of the port's steady-state federated round: the
port's copy of the JAX package's ``scripts/tpu_profile.py``.

It builds the headline round (``--target cifar``: ResNet9, d = 6,568,640,
8 clients, a 5 x 500k sketch, k = 50k) or GPT-2 double heads under
``--bf16`` with 4 clients (``--target gpt2``) through ``bench_rounds``,
runs 3 warm-up rounds, then ``--rounds`` rounds (default 10) under
``torch.profiler`` (CPU and CUDA activities, ``record_shapes``) ending in
a device sync, and writes the JAX layout that ``profile_diff`` parses:
the header (wall and device busy ms a round), "## By category",
"## Per-round counters", the port kernels, each category's launching
aten ops and "## Top 40 ops".

The rows are the device side of the trace: kernels, copies and memsets.
The device mirrors of the round's spans (``ANNOTATIONS``) and other user
annotations are dropped, since they span the kernels under them. Each
row is bucketed by ``category``: by the kernel's name, and where the name
carries no shape, by the aten op that launched it (the profiler's
correlation id, then the op's parents on the host) and that op's input
shapes. A 1-D tensor of at least 10^6 elements, or a ``(T, S, 128)``
plane of as many, is d-sized; a kernel is in the server phase if its
launching op ran inside ``fed_server_phase``. A kernel whose launching op
is not found keeps its name's bucket, and the report states how many
device ms a round that was.

    python -m commefficient_torch.scripts.round_profile [--target gpt2]
        [--rounds N] [--fused_epilogue | --stream_sketch |
        --sketch_coalesce] [--out DIR_OR_MD]

By default the report goes to ``docs/torch/round_profile{,_gpt2}{,_fused,
_stream,_coalesce}.md`` and the raw Chrome trace under ``runs/``; the
header names the card and its power limit. ``--device cpu`` is the
parser self-test at the JAX bench's tiny ResNet9 geometry: its rows are
aten ops by self CPU time, its header says so, and it writes under
``runs/`` or ``--out`` only, never under ``docs/``. Without ``--device
cpu`` on a host with no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the round's profiler spans (``annotate``): the engine's round and drain,
# the client and server phases, the streamed tiers' gather. Their device
# mirrors span the kernels under them, so a device-time sum drops them.
ANNOTATIONS = ("fed_round", "fed_drain", "fed_client_phase",
               "fed_server_phase", "fed_offload_gather")
SERVER_SPAN = "fed_server_phase"

# the port's kernel functions as the profiler names them (demangled or not)
KERNEL_SYMBOLS = (
    ("sketch_accumulate_into", ("sketch_accumulate_kernel<true>",
                                "sketch_accumulate_kernelILb1E")),
    ("sketch_accumulate", ("sketch_accumulate_kernel<false>",
                           "sketch_accumulate_kernelILb0E")),
    ("sketch_estimates", ("sketch_estimates_kernel",)),
    ("fused_epilogue", ("fused_epilogue_kernel",)),
    ("topk_count_ge", ("topk_count_ge_kernel",)),
    ("topk_descent", ("topk_descent_kernel",)))


def kernel_of(key: str):
    """The port kernel a profiler row belongs to, or None."""
    for name, symbols in KERNEL_SYMBOLS:
        if any(sym in key for sym in symbols):
            return name
    return None


def dev_us(e):
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


# The category keys. Those that ``profile_diff``'s presets and the
# counter registry read keep the JAX script's spelling; a unit in
# parentheses names the card's counterpart where the TPU's would be wrong
# ("convolution (MXU)" -> "convolution (cuDNN)"), which leaves each
# preset's substring governing the same bucket.
CONV = "convolution (cuDNN)"
MATMUL = "matmul (cuBLAS)"
EPILOGUE = "server epilogue (d-plane sweeps)"
CLIENT_ACCUM = "client sketch accumulate (launches)"
CLIENT_MOVE = "client flatten/movement (d-sized)"
TRANSMIT = "reduce (transmit collectives)"
COLLECTIVES = "collectives"
SCATTER = "scatter (index writes)"
GATHER = "gather"
SORT = "sort"
PORT = "custom-call (port kernels)"
MOVEMENT = "data movement"
RNG = "rng"
REDUCE = "reduce"
ELEMENTWISE = "elementwise fusion"
OTHER = "other"
CATEGORIES = (CONV, MATMUL, EPILOGUE, CLIENT_ACCUM, CLIENT_MOVE, TRANSMIT,
              COLLECTIVES, SCATTER, GATHER, SORT, PORT, MOVEMENT, RNG,
              REDUCE, ELEMENTWISE, OTHER)

# The server epilogue's sweeps as the JAX script counts them: the query,
# the count passes, the one-launch descent and the fused epilogue. The
# running-table accumulate is client-phase only, so its spans a round are
# the client phase's sketch launches; the zero-table accumulate also
# serves the server's re-sketch and stays out of both buckets, as the JAX
# script leaves ``_sketch_vec_pallas`` out.
_KERNEL_CATEGORY = {"sketch_estimates": EPILOGUE, "fused_epilogue": EPILOGUE,
                    "topk_count_ge": EPILOGUE, "topk_descent": EPILOGUE,
                    "sketch_accumulate_into": CLIENT_ACCUM,
                    "sketch_accumulate": PORT}

_CONV_RE = re.compile(r"conv(?!ert)|cudnn|dgrad|wgrad|fprop|implicit_gemm"
                      r"|im2col|col2im|winograd")
_MATMUL_RE = re.compile(r"gemm|nvjet|cutlass|matmul|\bdot\b|aten::(addmm|mm"
                        r"|bmm|baddbmm|addbmm|linear)\b")
_TRANSMIT_RE = re.compile(r"all_?gather|all-gather|reduce_?scatter"
                          r"|reduce-scatter|all_?to_?all|all-to-all")
_COLLECTIVE_RE = re.compile(r"all_?reduce|all-reduce|nccl|gloo|c10d"
                            r"|send_?recv|record_param_comms|collective")
# the aten ops that lay a flat vector out: the JAX script's concatenate /
# pad / reshape / convert / slice / split / copy, and the zero fill of a
# padded plane
_MOVEMENT_OPS = frozenset((
    "cat", "concat", "concatenate", "stack", "pad", "constant_pad_nd",
    "reshape", "_reshape_alias", "view", "_unsafe_view", "flatten",
    "unflatten", "copy_", "_to_copy", "to", "clone", "contiguous", "slice",
    "split", "split_with_sizes", "narrow", "chunk", "unbind", "new_zeros",
    "zeros", "zeros_like", "zero_", "fill_"))
_NAME_RULES = (
    (re.compile(r"scatter|index_put|index_add|indexput"), SCATTER),
    (re.compile(r"gather|index_select|indexselect|index_elementwise"),
     GATHER),
    (re.compile(r"sort"), SORT),
    (re.compile(r"copy|transpose|memcpy|memset|reshape|bitcast"), MOVEMENT),
    (re.compile(r"rng|philox|curand|distribution|random|bernoulli"), RNG),
    (re.compile(r"reduce|softmax|norm"), REDUCE),
    (re.compile(r"elementwise|foreach|pointwise|fusion|where"), ELEMENTWISE),
)
D_SIZED = 10 ** 6
LANES = 128


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def d_sized(shapes) -> bool:
    """Whether an op's input shapes hold a d-sized plane: a 1-D tensor of
    at least 10^6 elements, a ``(T, S, 128)`` plane of as many, or a
    tensor list of 1-D tensors that adds up to as many (a concatenation,
    whose result is the 1-D tensor)."""
    for s in shapes or ():
        s = list(s) if s is not None else []
        if s and all(isinstance(t, (list, tuple)) for t in s):
            if all(len(t) == 1 for t in s) and \
                    sum(int(t[0]) for t in s) >= D_SIZED:
                return True
            if any(d_sized([t]) for t in s):
                return True
            continue
        if not all(isinstance(t, int) for t in s):
            continue
        if len(s) == 1 and s[0] >= D_SIZED:
            return True
        if len(s) == 3 and s[-1] == LANES and _numel(s) >= D_SIZED:
            return True
    return False


def _op_base(name: str) -> str:
    return name.split("::", 1)[-1].split(".", 1)[0]


def category(name: str, ops: Sequence[str] = (), shapes=(),
             server: bool = False) -> str:
    """The category of one profiler row: a device kernel's (or, in the
    CPU self-test, an aten op's) ``name``; ``ops`` the names of the aten
    ops that launched it, innermost first (empty where none was found);
    ``shapes`` the innermost op's input shapes; ``server`` whether it ran
    inside ``fed_server_phase``."""
    kernel = kernel_of(name)
    if kernel is not None:
        return _KERNEL_CATEGORY[kernel]
    n = name.lower()
    if _CONV_RE.search(n):
        return CONV
    if _MATMUL_RE.search(n):
        return MATMUL
    if "xmma" in n:
        return CONV
    both = " ".join([n] + [o.lower() for o in ops])
    if _TRANSMIT_RE.search(both):
        return TRANSMIT
    if _COLLECTIVE_RE.search(both):
        return COLLECTIVES
    if d_sized(shapes):
        # every op that reads or writes a model-sized plane between the
        # aggregated transmit and the weight update
        if server:
            return EPILOGUE
        if any(_op_base(o) in _MOVEMENT_OPS for o in ops):
            return CLIENT_MOVE
    for pat, cat in _NAME_RULES:
        if pat.search(n):
            return cat
    return OTHER


class Span(NamedTuple):
    """One device row of a capture (in the CPU self-test, one aten op's
    self time)."""

    name: str
    us: float
    category: str
    attributed: bool  # its launching aten op was found
    server: bool
    op: str = ""  # the launching aten op, innermost


class Row(NamedTuple):
    """The spans of one name: ``key``, ``count`` and their device us."""

    key: str
    count: int
    self_device_time_total: float


@dataclasses.dataclass
class RoundProfile:
    """``rounds`` rounds under ``torch.profiler``: the host clock over
    them (ending in a device sync) and the device rows."""

    rounds: int
    wall_ms: float
    device: str
    spans: List[Span]

    @property
    def busy_ms(self) -> float:
        return sum(s.us for s in self.spans) / 1e3

    def _totals(self, key) -> Dict:
        """``{key(span): (spans, us)}`` over the spans ``key`` does not
        map to None."""
        agg: Dict = defaultdict(lambda: [0, 0.0])
        for s in self.spans:
            k = key(s)
            if k is not None:
                agg[k][0] += 1
                agg[k][1] += s.us
        return {k: (c, us) for k, (c, us) in agg.items()}

    def rows(self) -> List[Row]:
        """Spans aggregated by name, busiest first."""
        return sorted((Row(k, c, us) for k, (c, us) in
                       self._totals(lambda s: s.name).items()),
                      key=lambda r: -r.self_device_time_total)

    def categories(self) -> Dict[str, Tuple[int, float]]:
        """``{category: (spans, us)}`` over the capture."""
        return self._totals(lambda s: s.category)

    def launching_ops(self, top: int = 5) -> List[Tuple[str, str, int,
                                                          float]]:
        """``(category, launching op, spans, us)``: each category's ``top``
        launching aten ops by device time, categories busiest first."""
        agg = self._totals(lambda s: (s.category, s.op or "(none)"))
        cats = self.categories()
        out = []
        for cat in sorted(cats, key=lambda c: -cats[c][1]):
            rows = sorted(((op, c, us) for (k, op), (c, us) in agg.items()
                           if k == cat), key=lambda r: -r[2])
            out += [(cat, op, c, us) for op, c, us in rows[:top]]
        return out

    def kernels(self) -> Dict[str, Tuple[float, float]]:
        """``{port kernel: (spans a round, device ms a round)}``."""
        got = self._totals(lambda s: kernel_of(s.name))
        n = self.rounds
        return {name: (got.get(name, (0, 0.0))[0] / n,
                       got.get(name, (0, 0.0))[1] / 1e3 / n)
                for name, _ in KERNEL_SYMBOLS}

    @property
    def unattributed_ms(self) -> float:
        """Device ms a round whose launching aten op was not found and
        that are not the port's kernels (those are launched through
        ``ctypes``, outside any aten op, and bucketed by their symbols)."""
        return sum(s.us for s in self.spans if not s.attributed
                   and kernel_of(s.name) is None) / 1e3 / self.rounds


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name in ANNOTATIONS


def _shapes(e):
    structured = getattr(e, "structured_input_shapes", None)
    return structured if structured else (e.input_shapes or ())


def _span(name: str, us: float, op) -> Span:
    chain = []
    while op is not None:
        chain.append(op)
        op = op.cpu_parent
    aten = [c for c in chain if not _is_annotation(c)]
    server = any(c.name == SERVER_SPAN for c in chain)
    shapes = next((_shapes(c) for c in aten if any(_shapes(c))), ())
    ops = [c.name for c in aten]
    return Span(name, us, category(name, ops, shapes, server), bool(aten),
                server, ops[0] if ops else "")


def spans_of(events, cuda: bool) -> List[Span]:
    """The rows of a profiler's ``events()``. On the card: each device
    event (kernel, copy, memset) but the spans' mirrors and user
    annotations, with the host event that launched it and that event's
    parents. The profiler links a device event to the innermost host
    event open at its launch (an aten op, or a span where no op was
    open) and lists it in that event's ``kernels``; a device event that
    no host event lists is a row of its own, unattributed. On the CPU:
    each aten op by self CPU time."""
    from torch.autograd import DeviceType

    host = [e for e in events
            if e.device_type == DeviceType.CPU and not e.is_async]
    spans = []
    if not cuda:
        for e in host:
            if not _is_annotation(e) and e.self_cpu_time_total > 0:
                spans.append(_span(e.name, float(e.self_cpu_time_total), e))
        return spans
    # each device event counts once: a (name, duration) that several host
    # events list goes to them in turn
    owners = defaultdict(deque)
    for op in host:
        if not getattr(op, "is_legacy", False):
            for k in op.kernels:
                owners[(k.name, k.duration)].append(op)
    for e in events:
        us = dev_us(e) if e.device_type == DeviceType.CUDA else 0
        if us > 0 and not _is_annotation(e):
            q = owners.get((e.name, us))
            spans.append(_span(e.name, float(us), q.popleft() if q else None))
    return spans


def capture(run, n: int, device="cuda", finish=None,
            record_shapes: bool = True, trace_path: Optional[str] = None
            ) -> RoundProfile:
    """``n`` calls of ``run`` (then ``finish``, if given) under
    ``torch.profiler``, ending in a device sync on the card. ``device``
    ``cpu`` profiles the host only. ``trace_path``: also write the Chrome
    trace there."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        if finish is not None:
            finish()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if trace_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)),
                    exist_ok=True)
        prof.export_chrome_trace(trace_path)
    return RoundProfile(n, wall_ms, "cuda" if cuda else "cpu",
                        spans_of(prof.events(), cuda))


def device_rows(one_round, n: int, finish=None):
    """``n`` calls of ``one_round`` (then ``finish``) under
    ``torch.profiler`` on the card: the device-side rows (kernels,
    copies, memsets; the CPU ops that launched them would count the same
    time twice), busiest first, and the wall ms."""
    prof = capture(one_round, n, finish=finish, record_shapes=False)
    return prof.rows(), prof.wall_ms


# The per-round counter registry of the JAX script: each counter is the
# span count of one category bucket divided by the traced rounds, and the
# profile_diff preset that gates it.
# rows: (category key, slug, gating profile_diff preset, doc)
COUNTERS = (
    (EPILOGUE, "epilogue_sweeps", "fused-epilogue", "docs/fused_epilogue.md"),
    (CLIENT_MOVE, "client_movement", "stream-sketch", "docs/stream_sketch.md"),
    (TRANSMIT, "transmit_collectives", "sharded-server",
     "docs/sharded_server.md"),
    (CLIENT_ACCUM, "client_sketch_launches", "sketch-coalesce",
     "docs/stream_sketch.md"),
)


def write_report(prof: RoundProfile, out_md: str, title: str, geometry: str,
                 where: str) -> str:
    """The capture in the JAX script's layout. ``where``: the card (its
    ``nvidia-smi`` name and power limit) or the CPU self-test's note."""
    n = prof.rounds
    total_us = prof.busy_ms * 1e3
    cats = prof.categories()
    cat_rows = sorted(cats.items(), key=lambda kv: -kv[1][1])
    rows = prof.rows()
    pct = (lambda us: 100 * us / total_us) if total_us else (lambda us: 0.0)
    os.makedirs(os.path.dirname(os.path.abspath(out_md)), exist_ok=True)
    with open(out_md, "w") as f:
        f.write(f"# Per-op profile: {title}\n\n")
        f.write(f"Captured {time.strftime('%Y-%m-%d %H:%M:%S')} {where}, "
                f"{geometry}, {n} steady-state rounds traced "
                f"(`commefficient_torch/scripts/round_profile.py`).\n\n")
        cuda = prof.device == "cuda"
        rows_are = ("device events (kernels, copies, memsets)" if cuda
                    else "aten ops by self CPU time")
        f.write(f"Wall clock: **{prof.wall_ms / n:.2f} ms/round** (host "
                f"clock under the profiler"
                f"{', ending in a device sync' if cuda else ''}). Rows: "
                f"`torch.profiler` {rows_are}, device busy time "
                f"{total_us / 1e3 / n:.2f} ms/round "
                f"({total_us / 1e3:.1f} ms total).\n\n")
        f.write(f"Unattributed: {prof.unattributed_ms:.3f} ms/round of "
                f"rows had no launching aten op and kept their name's "
                f"bucket (the port's six kernels, bucketed by their "
                f"symbols, are not counted here).\n\n")
        f.write("## By category\n\n")
        f.write("| category | spans | total ms | ms/round | % busy |\n")
        f.write("|---|---|---|---|---|\n")
        for cat, (cnt, us) in cat_rows:
            f.write(f"| {cat} | {cnt} | {us / 1e3:.2f} | "
                    f"{us / 1e3 / n:.3f} | {pct(us):.1f}% |\n")
        f.write("\n## Per-round counters\n\n")
        f.write("| counter | category | ops/round | ms/round | gate "
                "(profile_diff --preset) | doc |\n")
        f.write("|---|---|---|---|---|---|\n")
        for cat_key, slug, preset, doc in COUNTERS:
            cnt, us = cats.get(cat_key, (0, 0.0))
            f.write(f"| {slug} | {cat_key} | {cnt / n:.1f} | "
                    f"{us / 1e3 / n:.3f} | {preset} | {doc} |\n")
        f.write("\n## Port kernels\n\n")
        f.write("| kernel | spans/round | ms/round |\n|---|---|---|\n")
        for name, (spans, ms) in prof.kernels().items():
            f.write(f"| {name} | {spans:.1f} | {ms:.4f} |\n")
        f.write("\n## Launching ops by category\n\n")
        f.write("| category | launching aten op | spans | ms/round |\n")
        f.write("|---|---|---|---|\n")
        for cat, op, cnt, us in prof.launching_ops():
            f.write(f"| {cat} | `{op}` | {cnt} | {us / 1e3 / n:.3f} |\n")
        f.write("\n## Top 40 ops\n\n")
        f.write("| op | count | total ms | ms/round | % busy |\n")
        f.write("|---|---|---|---|---|\n")
        for r in rows[:40]:
            safe = r.key.replace("|", "\\|")[:90]
            us = r.self_device_time_total
            f.write(f"| `{safe}` | {r.count} | {us / 1e3:.2f} | "
                    f"{us / 1e3 / n:.3f} | {pct(us):.1f}% |\n")
    return out_md


def profile_rounds(one_round, n: int = 5, report=None,
                   record_shapes: bool = True) -> dict:
    """Device time by kernel and category over ``n`` rounds on the card,
    printed per round, and the device's busy share of the profiled wall
    time. ``report``: ``(out_md, title, geometry, where)`` to write the
    capture with ``write_report``. Without ``record_shapes`` no row is
    d-sized, so the two d-sized buckets stay empty."""
    prof = capture(one_round, n, record_shapes=record_shapes)
    busy_ms, wall_ms = prof.busy_ms, prof.wall_ms
    rows = prof.rows()
    cats = prof.categories()
    per_kernel = {k: ms for k, (_, ms) in prof.kernels().items()}
    print(f"profile: {n} rounds, wall {wall_ms / n:.3f} ms/round under the "
          f"profiler, device busy {busy_ms / n:.3f} ms/round "
          f"({100 * busy_ms / wall_ms:.1f}%), unattributed "
          f"{prof.unattributed_ms:.4f} ms/round")
    print("  by category (ms/round): " + json.dumps(
        {k: round(us / n / 1e3, 4) for k, (_, us) in
         sorted(cats.items(), key=lambda kv: -kv[1][1])}))
    for e in rows[:16]:
        print(f"  {dev_us(e) / n / 1e3:8.3f} ms/round  {e.count / n:6.1f} "
              f"calls/round  {e.key[:90]}")
    print("  port kernels (device ms/round): " + json.dumps(per_kernel))
    memsets = sum(e.count for e in rows if "memset" in e.key.lower()) / n
    device_ops = sum(e.count for e in rows) / n
    print(f"  device memsets per round: {memsets:g}, device operations "
          f"(kernels, copies, memsets) per round: {device_ops:g}")
    out = {"profiled_busy_ms_per_round": busy_ms / n,
           "profiled_wall_ms_per_round": wall_ms / n,
           "kernel_ms_per_round": per_kernel,
           "kernel_spans_per_round": {k: spans for k, (spans, _) in
                                      prof.kernels().items()},
           "category_ms_per_round": {k: us / n / 1e3
                                     for k, (_, us) in cats.items()},
           "unattributed_ms_per_round": prof.unattributed_ms,
           "memsets_per_round": memsets,
           "device_ops_per_round": device_ops}
    if report is not None:
        out["capture"] = write_report(prof, *report)
        print(f"  capture written to {out['capture']}")
    return out


_TITLES = {
    "cifar": ("fused CIFAR federated round",
              "full bench geometry (ResNet9 d={d}, 8 workers, sketch "
              "5x500k k=50k)"),
    "gpt2": ("fused GPT-2 PersonaChat federated round",
             "full bench geometry (GPT-2 124M double-heads bf16 d={d}, "
             "4 workers, sketch 5x500k k=50k)"),
}
VARIANTS = (("fused_epilogue", "_fused", ["--fused_epilogue"]),
            ("stream_sketch", "_stream", ["--stream_sketch"]),
            ("sketch_coalesce", "_coalesce",
             ["--stream_sketch", "--sketch_coalesce"]))
WARMUP_ROUNDS = 3


def card_where() -> str:
    """The header's note of the card: ``nvidia-smi``'s name and power
    limit, and the versions."""
    from commefficient_torch.scripts.evidence import card_line

    return (f"on `{card_line() or torch.cuda.get_device_name(0)}` "
            f"(`nvidia-smi --query-gpu=name,power.limit`; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda})")


def geometry_of(target: str, d: int, flags: Sequence[str],
                tiny: bool = False) -> str:
    """The header's geometry for a capture of ``target`` with the variant
    ``flags``."""
    geom = (f"tiny CPU geometry (ResNet9 d={d:,}, 8 workers, sketch 3x8192 "
            f"k=512) — a CPU self-test of the parser, NOT a device "
            f"measurement: the rows are aten ops by self CPU time" if tiny
            else
            _TITLES[target][1].format(d=f"{d:,}"))
    return geom + "".join(f", {f}" for f in flags)


def default_name(target: str, suffix: str) -> str:
    return ("round_profile" + ("" if target == "cifar" else f"_{target}")
            + suffix + ".md")


def main(argv=None) -> int:
    from commefficient_torch.federated.aggregator import resolve_device
    from commefficient_torch.scripts import bench_rounds

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", choices=("cifar", "gpt2"), default="cifar")
    ap.add_argument("--rounds", type=int, default=10)
    for flag, _, _ in VARIANTS:
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None,
                    help="the report's path (.md) or directory")
    args = ap.parse_args(argv)
    chosen = [v for v in VARIANTS if getattr(args, v[0])]
    if len(chosen) > 1:
        ap.error("give only one of --fused_epilogue / --stream_sketch / "
                 "--sketch_coalesce per capture: a combined capture has no "
                 "baseline to diff against")
    cpu = args.device == "cpu"
    if cpu and args.target == "gpt2":
        ap.error("the gpt2 target runs on the card only (d = 124M)")
    suffix, flags = (chosen[0][1], chosen[0][2]) if chosen else ("", [])
    name = default_name(args.target, suffix)
    if args.out is None:
        out_md = os.path.join(_REPO, *(("runs", "round_profile_selftest.md")
                                       if cpu else ("docs", "torch", name)))
    elif args.out.endswith(".md"):
        out_md = args.out
    else:
        out_md = os.path.join(args.out, name)
    docs = os.path.join(_REPO, "docs") + os.sep
    if cpu and os.path.abspath(out_md).startswith(docs):
        ap.error("the CPU self-test writes under runs/ or --out, never "
                 "under docs/")
    device = resolve_device(args.device)

    if args.target == "gpt2":
        _, fm, _, _, one_round = bench_rounds.build_gpt2(
            ["--bf16"] + flags, device=str(device))
        batch = bench_rounds.gpt2_batch()
    else:
        _, fm, _, _, one_round = bench_rounds.build_round(
            flags, device=str(device), tiny=cpu)
        batch = bench_rounds.synthetic_batch()
    print(f"warm-up: {WARMUP_ROUNDS} rounds", flush=True)
    for _ in range(WARMUP_ROUNDS):
        one_round(batch)
    trace = None if cpu else os.path.join(
        _REPO, "runs", f"round_profile_trace_{args.target}{suffix}",
        "trace.json")
    print(f"tracing {args.rounds} rounds", flush=True)
    prof = capture(lambda: one_round(batch), args.rounds, device,
                   trace_path=trace)
    title = _TITLES[args.target][0]
    where = ("on the CPU" if cpu else card_where())
    write_report(prof, out_md, title,
                 geometry_of(args.target, fm.grad_size, flags, tiny=cpu),
                 where)
    n = args.rounds
    print(f"wall {prof.wall_ms / n:.2f} ms/round, busy "
          f"{prof.busy_ms / n:.2f} ms/round, unattributed "
          f"{prof.unattributed_ms:.3f} ms/round; port kernel spans/round "
          + json.dumps({k: spans for k, (spans, _) in
                        prof.kernels().items()}))
    print(f"wrote {out_md}" + (f" (raw trace {trace})" if trace else ""),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
