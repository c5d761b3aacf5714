"""The traced part of a ``--trace 1`` run: a ``torch.profiler`` capture of
whole rounds, reduced to the device rows the per-layer readers take.

The attribution is a frozen copy of the port's
``commefficient_torch/scripts/round_profile.py`` (``ANNOTATIONS``,
``KERNEL_SYMBOLS``, ``kernel_of``, the categories and ``category``, the
owner lookup of ``spans_of``), so a later change to the program's tool
does not move this yardstick. Each device row (kernel, copy, memset; the
spans' device mirrors and user annotations dropped) keeps its category,
its start and duration on the profiler's clock, and the names of the
round's host spans it was launched under (the launching host event and
its parents, or, for the backward pass that autograd runs on a thread of
its own, the spans open when that event started). The capture records no
shapes and no stacks.
"""

from __future__ import annotations

import re
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

ANNOTATIONS = ("fed_round", "fed_drain", "fed_client_phase",
               "fed_server_phase", "fed_offload_gather")

KERNEL_SYMBOLS = (
    ("sketch_accumulate_into", ("sketch_accumulate_kernel<true>",
                                "sketch_accumulate_kernelILb1E")),
    ("sketch_accumulate", ("sketch_accumulate_kernel<false>",
                           "sketch_accumulate_kernelILb0E")),
    ("sketch_estimates", ("sketch_estimates_kernel",)),
    ("fused_epilogue", ("fused_epilogue_kernel",)),
    ("topk_count_ge", ("topk_count_ge_kernel",)),
    ("topk_descent", ("topk_descent_kernel",)))


def kernel_of(key: str) -> Optional[str]:
    """The port kernel a device row belongs to, or None."""
    for name, symbols in KERNEL_SYMBOLS:
        if any(sym in key for sym in symbols):
            return name
    return None


def dev_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


CONV = "convolution (cuDNN)"
MATMUL = "matmul (cuBLAS)"
EPILOGUE = "server epilogue (d-plane sweeps)"
CLIENT_ACCUM = "client sketch accumulate (launches)"
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


def category(name: str, ops: Sequence[str] = ()) -> str:
    """The category of a device row ``name`` launched by the host events
    ``ops`` (innermost first)."""
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
    for pat, cat in _NAME_RULES:
        if pat.search(n):
            return cat
    return OTHER


class Op(NamedTuple):
    """One device row: times in us on the profiler's clock."""

    name: str
    start: float
    us: float
    category: str
    spans: frozenset  # the round's host spans it was launched under


class Capture(NamedTuple):
    """``rounds`` whole rounds under the profiler: the device rows, the
    round's host spans ``(name, start, end)`` and the window ``(start,
    end)``, all on the profiler's clock."""

    rounds: int
    ops: List[Op]
    spans: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device rows' intervals inside the window,
        merged and in time order."""
        lo, hi = self.window
        out: List[List[float]] = []
        for a, b in sorted((max(o.start, lo), min(o.start + o.us, hi))
                           for o in self.ops):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's device-idle intervals."""
        lo, hi = self.window
        out, t = [], lo
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def span_at(self, t: float) -> str:
        """The innermost of ``fed_drain`` and ``fed_round`` open on the
        host at ``t``, or ``outside``."""
        for name in ("fed_drain", "fed_round"):
            if any(n == name and a <= t <= b for n, a, b in self.spans):
                return name
        return "outside"


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name in ANNOTATIONS


def _op(e, us: float, owner, host_spans) -> Op:
    """A device row. Its spans are those in its launching host event's
    chain of parents; where the chain has none (autograd runs the backward
    pass on a thread of its own, whose events have no parent on the
    calling thread), those open on the host when the launching event
    started."""
    chain = []
    op = owner
    while op is not None:
        chain.append(op)
        op = op.cpu_parent
    ops = [c.name for c in chain if not _is_annotation(c)]
    spans = frozenset(c.name for c in chain if c.name in ANNOTATIONS)
    if not spans and owner is not None:
        t = owner.time_range.start
        spans = frozenset(n for n, a, b in host_spans if a <= t <= b)
    return Op(e.name, float(e.time_range.start), float(us),
              category(e.name, ops), spans)


def ops_of(events) -> Tuple[List[Op], List[Tuple[str, float, float]]]:
    """The device rows of a profiler's ``events()`` with their launching
    host event (the event that lists the row in its ``kernels``; a row no
    host event lists keeps no spans), and the round's host spans."""
    from torch.autograd import DeviceType

    host = [e for e in events
            if e.device_type == DeviceType.CPU and not e.is_async]
    owners = defaultdict(deque)
    for op in host:
        if not getattr(op, "is_legacy", False):
            for k in op.kernels:
                owners[(k.name, k.duration)].append(op)
    spans = [(e.name, float(e.time_range.start), float(e.time_range.end))
             for e in host if e.name in ANNOTATIONS]
    ops = []
    for e in events:
        us = dev_us(e) if e.device_type == DeviceType.CUDA else 0
        if us > 0 and not _is_annotation(e):
            q = owners.get((e.name, us))
            ops.append(_op(e, us, q.popleft() if q else None, spans))
    return ops, spans


def capture(run_round, rounds: int) -> Capture:
    """``rounds`` calls of ``run_round`` under ``torch.profiler`` with CPU
    and CUDA activities, no shapes, no stacks, ending in a device sync."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        for _ in range(rounds):
            run_round()
        torch.cuda.synchronize()
    ops, spans = ops_of(prof.events())
    rounds_spans = [s for s in spans if s[0] == "fed_round"]
    ends = [o.start + o.us for o in ops] + [b for _, _, b in spans]
    lo = min([a for _, a, _ in rounds_spans] or [o.start for o in ops]
             or [0.0])
    hi = max(ends or [lo])
    return Capture(rounds, ops, spans, (lo, hi))


def breakdown(cap: Capture, top: int = 10) -> Dict[str, list]:
    """The device time of each category, largest first, and the longest
    device-idle gaps, each named by the host span it fell in (seconds)."""
    per: Dict[str, float] = defaultdict(float)
    for o in cap.ops:
        per[o.category] += o.us
    device_ops = sorted(([k, v / 1e6] for k, v in per.items()),
                        key=lambda kv: -kv[1])[:top]
    gaps = sorted(cap.gaps(), key=lambda g: g[0] - g[1])[:top]
    idle = [[cap.span_at(0.5 * (a + b)), (b - a) / 1e6] for a, b in gaps]
    return {"device_ops": device_ops, "idle_gaps": idle}
