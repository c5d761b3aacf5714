"""The port's kernels' share of their roofline, in %: the sum over their
launches in the traced window of each launch's least time on the card
(``fedbench/counts.py``: the operation's bytes and operations from the
sketch's shapes, every launch over the full ``d``) over the sum of their
device time. Each kernel's launches, time, bound and what bounds it are
printed on standard error."""

import sys
from collections import defaultdict

from fedbench import counts, trace


def read(ctx):
    cap = ctx.capture
    rec = ctx.cell.recipe
    if rec["mode"] != "sketch":
        return None
    d = ctx.d()
    r = int(rec["num_rows"])
    c_pad = -(-int(rec["num_cols"]) // 128) * 128
    peak = counts.peaks(ctx.card)
    per = defaultdict(lambda: [0, 0.0])
    for o in cap.ops:
        k = trace.kernel_of(o.name)
        if k is not None:
            per[k][0] += 1
            per[k][1] += o.us / 1e3
    bound_ms = dev_ms = 0.0
    for k, (n, ms) in sorted(per.items()):
        w = counts.kernel_work(k, d, r, c_pad)
        b = counts.bound(w["bytes"], w["int_ops"], w["flops"], peak)
        bound_ms += n * b["bound_ms"]
        dev_ms += ms
        print(f"roofline {k}: {n} launches, {ms / n:.5f} ms each, bound "
              f"{b['bound_ms']:.5f} ms by {b['bound_by']}", file=sys.stderr)
    return 100.0 * bound_ms / dev_ms if dev_ms else None
