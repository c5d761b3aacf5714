"""The median over the traced drains of the device's idle time around a
``fed_drain`` span: the length of every idle gap that overlaps the span
(a gap that opens while the host drains lasts until the next round's
first kernel)."""

import statistics


def read(ctx):
    cap = ctx.capture
    drains = [(a, b) for n, a, b in cap.spans if n == "fed_drain"]
    if not drains or not cap.ops:
        return None
    gaps = cap.gaps()
    per = [sum(g1 - g0 for g0, g1 in gaps if g0 <= b and g1 >= a) / 1e3
           for a, b in drains]
    return statistics.median(per)
