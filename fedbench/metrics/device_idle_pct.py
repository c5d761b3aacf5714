"""The share of the traced window in which no device row ran, in %."""


def read(ctx):
    cap = ctx.capture
    lo, hi = cap.window
    if not cap.ops or hi <= lo:
        return None
    busy = sum(b - a for a, b in cap.busy())
    return 100.0 * (1.0 - busy / (hi - lo))
