"""The whole round's share of the card's peak, in %: the model FLOPs of
the cohort's forward and backward (counted from the configuration's
shapes, nothing recomputed) times the plain part's rounds/s, over the
card's float32 peak outside the tensor cores, the configuration's
precision being float32 with TF32 off (67 TFLOP/s on an H100 SXM; the
card's name and power limit are on the run's first line)."""

from fedbench import counts


def read(ctx):
    if ctx.rounds_per_s <= 0:
        return None
    flops = counts.peaks(ctx.card)[1]
    return 100.0 * ctx.round_flops() * ctx.rounds_per_s / flops
