"""Diff two per-op profile captures by category: the port's copy of the
JAX package's ``scripts/profile_diff.py``, plain Python with no JAX.

It parses the "## By category" table and the wall/busy header out of two
capture files written by ``commefficient_torch/scripts/round_profile.py``
(or by the JAX package's ``scripts/tpu_profile.py``: the layout is the
same) and prints the per-category delta table, plus one delta table for
the per-round counter registry ("## Per-round counters",
``round_profile.COUNTERS``; legacy prose-counter captures parse too).

Usage:
    python -m commefficient_torch.scripts.profile_diff BEFORE.md AFTER.md

e.g. the fused epilogue against the headline round on the card:
    python -m commefficient_torch.scripts.profile_diff \
        docs/torch/round_profile.md docs/torch/round_profile_fused.md \
        --preset fused-epilogue

Exit status: 0 on a clean diff, 2 on unparseable input. Pass
``--fail-above-pct CAT=PCT`` (repeatable) to exit 1 when a category's
ms/round grew by more than PCT percent — the CI regression hook.
``--preset NAME`` expands to a named budget set:

- ``round-engine``   — the pipelined-engine claim (data movement flat);
- ``sharded-server`` — the --server_shard claim (docs/sharded_server.md):
  the transmit collectives ("reduce (transmit collectives)" — the
  reduce-scatter / all-gather / all-to-all bucket) must not balloon, and
  the server step's signature categories — "custom-call" (the sketch
  kernels) and the plain "reduce" bucket — must SHRINK per device, so any
  growth at all fails the gate;
- ``fused-epilogue`` — the --fused_epilogue claim (docs/fused_epilogue.md):
  the "server epilogue (d-plane sweeps)" bucket must not grow at all
  (capture the pair with round_profile, the second with --fused_epilogue);
- ``stream-sketch`` — the --stream_sketch claim (docs/stream_sketch.md):
  the "client flatten/movement (d-sized)" bucket must not grow at all and
  is expected to collapse (the second capture with --stream_sketch);
- ``sketch-coalesce`` — the --sketch_coalesce claim: the "client sketch
  accumulate (launches)" bucket must not grow (diff the --sketch_coalesce
  capture against the --stream_sketch one).
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, NamedTuple, Optional

# named --preset budget sets: category substring -> max allowed growth %
_PRESETS: Dict[str, Dict[str, float]] = {
    "round-engine": {"data movement": 25.0},
    "sharded-server": {
        "reduce (transmit collectives)": 25.0,
        "custom-call": 0.0,
        "reduce": 0.0,
    },
    # the --fused_epilogue claim (docs/fused_epilogue.md): the server
    # epilogue's d-plane sweep bucket (round_profile's "server epilogue
    # (d-plane sweeps)" category — the query, count-pass, descent and
    # fused-epilogue kernels and the server phase's d-sized ops — the mask
    # and the update sweeps) must not grow at
    # all — the fusion removes sweeps, so any growth is a regression. The
    # model itself must stay flat (convolutions unchanged by a server-side
    # fusion; 10% covers tenancy noise between captures).
    "fused-epilogue": {
        "server epilogue (d-plane sweeps)": 0.0,
        "convolution": 10.0,
    },
    # the --stream_sketch claim (docs/stream_sketch.md): the client
    # phase's d-sized flat-vector movement ("client flatten/movement
    # (d-sized)" — the 1-D concatenate/pad/copy bucket round_profile
    # emits) must not grow at all — the streaming
    # path deletes those ops, so any growth is a regression. The model
    # (convolution on CIFAR, matmul on GPT-2) must stay flat; 10% covers
    # tenancy noise between captures.
    "stream-sketch": {
        "client flatten/movement (d-sized)": 0.0,
        "convolution": 10.0,
        "matmul": 10.0,
    },
    # the --sketch_coalesce claim (docs/stream_sketch.md): the client
    # phase's sketch-accumulate launch bucket ("client sketch accumulate
    # (launches)" — the running-table sketch_accumulate_kernel<true>
    # spans round_profile counts) must not grow at all and is
    # expected to collapse from ~leaf count to the coalesced group count.
    # Diff the *_coalesce.md capture against the *_stream.md one (the
    # per-leaf streaming build is the baseline); the model itself must
    # stay flat (10% covers tenancy noise between captures).
    "sketch-coalesce": {
        "client sketch accumulate (launches)": 0.0,
        "convolution": 10.0,
        "matmul": 10.0,
    },
}


class Capture(NamedTuple):
    path: str
    wall_ms: Optional[float]  # ms/round wall clock (None in older captures)
    busy_ms: Optional[float]  # ms/round device busy
    # category -> (spans, ms_per_round)
    categories: Dict[str, "tuple[int, float]"]
    # counter slug -> (ops_per_round, ms_per_round) — the "## Per-round
    # counters" registry table (round_profile.COUNTERS). None
    # (not a shared {} class default) for captures predating it; read
    # through `cap.counters or {}`
    counters: Optional[Dict[str, "tuple[float, float]"]] = None


_WALL_RE = re.compile(r"Wall clock:\s*\*\*([\d.]+)\s*ms/round\*\*")
_BUSY_RE = re.compile(r"busy time\s*([\d.]+)\s*ms/round")
# | category | spans | total ms | ms/round | % busy |
_ROW_RE = re.compile(
    r"^\|\s*([^|]+?)\s*\|\s*(\d+)\s*\|\s*[\d.]+\s*\|\s*([\d.]+)\s*\|")
# | counter | category | ops/round | ms/round | gate | doc |
_COUNTER_RE = re.compile(
    r"^\|\s*(\w+)\s*\|\s*[^|]+\|\s*([\d.]+)\s*\|\s*([\d.]+)\s*\|")
# the pre-registry prose spelling ("Server epilogue d-plane sweeps:
# **12.0 ops/round** (0.41 ms/round)"), so a new capture still diffs
# against committed baselines written before the counters table existed
_LEGACY_COUNTER_RE = re.compile(
    r"^(.+?):\s*\*\*([\d.]+)\s*ops/round\*\*\s*\(([\d.]+)\s*ms/round\)")
_LEGACY_SLUGS = {
    "Server epilogue d-plane sweeps": "epilogue_sweeps",
    "Client flatten/movement (d-sized)": "client_movement",
}


def parse_capture(path: str) -> Capture:
    with open(path) as f:
        text = f.read()
    wall = _WALL_RE.search(text)
    busy = _BUSY_RE.search(text)

    cats: Dict[str, tuple] = {}
    counters: Dict[str, tuple] = {}
    section = None
    for line in text.splitlines():
        if line.startswith("## "):
            section = line.strip()
            continue
        m = _LEGACY_COUNTER_RE.match(line)
        if m and m.group(1).strip() in _LEGACY_SLUGS:
            counters.setdefault(_LEGACY_SLUGS[m.group(1).strip()],
                                (float(m.group(2)), float(m.group(3))))
            continue
        if section == "## Per-round counters":
            m = _COUNTER_RE.match(line)
            if m and m.group(1) != "counter":
                counters[m.group(1)] = (float(m.group(2)),
                                        float(m.group(3)))
            continue
        if section != "## By category":
            continue
        m = _ROW_RE.match(line)
        if not m:
            continue
        name = m.group(1)
        if name in ("category", ":---", "---"):
            continue
        cats[name] = (int(m.group(2)), float(m.group(3)))
    if not cats:
        raise ValueError(f"{path}: no '## By category' table found — is "
                         "this a round_profile capture?")
    return Capture(path=path,
                   wall_ms=float(wall.group(1)) if wall else None,
                   busy_ms=float(busy.group(1)) if busy else None,
                   categories=cats,
                   counters=counters)


def _fmt_delta(before: Optional[float], after: Optional[float]) -> str:
    if before is None or after is None:
        return "n/a"
    d = after - before
    pct = f" ({100 * d / before:+.1f}%)" if before else ""
    return f"{d:+.3f}{pct}"


def diff(a: Capture, b: Capture, fail_above: Dict[str, float]) -> int:
    print(f"before: {a.path}")
    print(f"after:  {b.path}\n")

    print("| category | spans (b→a) | ms/round before | ms/round after | "
          "delta |")
    print("|---|---|---|---|---|")
    # stable order: descending before-ms, categories new in `after` last
    names = sorted(set(a.categories) | set(b.categories),
                   key=lambda n: -a.categories.get(n, (0, 0.0))[1])
    failures = []
    for name in names:
        sa, ma = a.categories.get(name, (0, 0.0))
        sb, mb = b.categories.get(name, (0, 0.0))
        print(f"| {name} | {sa}→{sb} | {ma:.3f} | {mb:.3f} | "
              f"{_fmt_delta(ma, mb)} |")
        # most-specific (longest) matching pattern wins, so a broad
        # budget like "reduce" doesn't also govern
        # "reduce (transmit collectives)" when both are configured
        hits = [(pat, pct) for pat, pct in fail_above.items()
                if pat.lower() in name.lower()]
        if hits and ma > 0:
            pat, pct = max(hits, key=lambda kv: len(kv[0]))
            if 100 * (mb - ma) / ma > pct:
                failures.append(
                    f"{name}: {ma:.3f} → {mb:.3f} ms/round exceeds "
                    f"+{pct}% budget")
    print(f"| **device busy** | | "
          f"{a.busy_ms if a.busy_ms is not None else '?'} | "
          f"{b.busy_ms if b.busy_ms is not None else '?'} | "
          f"{_fmt_delta(a.busy_ms, b.busy_ms)} |")
    print(f"| **wall clock** | | "
          f"{a.wall_ms if a.wall_ms is not None else '?'} | "
          f"{b.wall_ms if b.wall_ms is not None else '?'} | "
          f"{_fmt_delta(a.wall_ms, b.wall_ms)} |")

    # the per-round counter registry (round_profile.COUNTERS):
    # ONE table for every counter, whichever capture carries it — no
    # preset-specific print paths. Counters are informational here; the
    # pass/fail gates stay on the category budgets above.
    a_counters, b_counters = a.counters or {}, b.counters or {}
    counter_names = sorted(set(a_counters) | set(b_counters))
    if counter_names:
        print("\n| counter (ops/round) | before | after | delta |")
        print("|---|---|---|---|")
        for name in counter_names:
            ca = a_counters.get(name, (None, None))[0]
            cb = b_counters.get(name, (None, None))[0]
            print(f"| {name} | {ca if ca is not None else '?'} | "
                  f"{cb if cb is not None else '?'} | "
                  f"{_fmt_delta(ca, cb)} |")

    # a budget that GOVERNS no nonzero-baseline category checks nothing
    # (e.g. the baseline predates a category rename, or a longer pattern
    # claims every row it matches) — say so instead of passing silently.
    # Governing = being the longest matching pattern, mirroring the
    # enforcement rule above.
    def governs(pat, name):
        matches = [p for p in fail_above if p.lower() in name.lower()]
        return bool(matches) and max(matches, key=len) == pat

    for pat in fail_above:
        if not any(governs(pat, n) and a.categories.get(n, (0, 0.0))[1] > 0
                   for n in names):
            print(f"WARNING: budget {pat!r} governs no category with a "
                  f"nonzero baseline — this gate is vacuous for these "
                  f"captures (baseline from an older category scheme?)",
                  file=sys.stderr)

    if failures:
        print("\nREGRESSION:", file=sys.stderr)
        for msg in failures:
            print(f"  {msg}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("before", help="baseline capture .md")
    p.add_argument("after", help="new capture .md")
    p.add_argument("--fail-above-pct", action="append", default=[],
                   metavar="CAT=PCT",
                   help="exit 1 if category CAT (substring match) grew "
                        "more than PCT%% in ms/round; repeatable")
    p.add_argument("--preset", choices=sorted(_PRESETS),
                   help="named budget set (see module docstring); "
                        "composes with --fail-above-pct, which wins on "
                        "a per-category conflict")
    args = p.parse_args(argv)
    fail_above = dict(_PRESETS.get(args.preset, {}))
    for spec in args.fail_above_pct:
        cat, _, pct = spec.partition("=")
        try:
            fail_above[cat] = float(pct)
        except ValueError:
            p.error(f"bad --fail-above-pct {spec!r} (want CAT=PCT)")
    try:
        a = parse_capture(args.before)
        b = parse_capture(args.after)
    except (OSError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2
    return diff(a, b, fail_above)


if __name__ == "__main__":
    sys.exit(main())
