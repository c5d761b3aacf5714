"""The yardstick's arithmetic: the card's peaks, the roofline bound, the
work of each port kernel's operation counted from the sketch's shapes,
and the model FLOPs of a round.

``peaks`` and ``bound`` are frozen copies of the port's
``commefficient_torch/profiling.py``. The kernel counts are of the
operation, not of an implementation: each input byte read once and each
output byte written once, the float adds of the count sketch, and the
ALU-pipe integer operations of its hash (the shifts and XORs of murmur3's
fmix32, seven a row and coordinate; its two multiplies run on the FMA
pipe and are not charged), so the same call gets the same bound whatever
kernel serves it. Every launch is charged the full coordinate range ``d``,
as the composed round launches it; a cell that streams the sketch by leaf
segments needs a reader of its own.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Tuple

import torch


def peaks(name: str) -> Tuple[float, float, float]:
    """``(bytes/s, float32 op/s, int32 op/s)`` of the card ``name``:
    NVIDIA's data-sheet memory and float32 rates; the int32 rate is the
    ALU pipe's (64 INT32 lanes an SM, the Hopper white paper) times the
    SM count times the maximum SM clock ``nvidia-smi`` reports, an
    assumption the data sheets do not state."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32 = 64 * sms * mhz * 1e6
    if "PCIe" in name:
        return 2.0e12, 51e12, int32
    if "NVL" in name:
        return 3.9e12, 60e12, int32
    if "H200" in name:
        return 4.8e12, 67e12, int32
    return 3.35e12, 67e12, int32  # H100 SXM


def bound(nbytes: float, int_ops: float, flops: float, peak) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their type's rate."""
    bw, frate, irate = peak
    tb, to = nbytes / bw, max(int_ops / irate, flops / frate)
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


HASH_OPS = 7  # fmix32's three shifts, three XORs and the key's XOR


def kernel_work(kernel: str, d: int, r: int, c_pad: int) -> Dict[str, float]:
    """``{"bytes", "int_ops", "flops"}`` of one launch of the port kernel
    ``kernel`` over the full range of ``d`` coordinates of an ``r x
    c_pad`` float32 table."""
    table = 4.0 * r * c_pad
    plane = 4.0 * d
    if kernel == "sketch_accumulate":
        # read the vector, write the table; per row and coordinate the
        # sign hash and one add
        return {"bytes": plane + table, "int_ops": HASH_OPS * r * d,
                "flops": 1.0 * r * d}
    if kernel == "sketch_accumulate_into":
        return {"bytes": plane + 2 * table, "int_ops": HASH_OPS * r * d,
                "flops": 1.0 * r * d}
    if kernel == "sketch_estimates":
        # read the table, write the estimates; per coordinate r signed
        # reads and the median's compare-exchanges
        return {"bytes": table + plane, "int_ops": HASH_OPS * r * d,
                "flops": (r + r * (r - 1)) * float(d)}
    if kernel == "fused_epilogue":
        # read the estimates, write the update and its table
        return {"bytes": 2 * plane + table,
                "int_ops": HASH_OPS * r * d + 1.0 * d,
                "flops": 1.0 * r * d}
    if kernel == "topk_count_ge":
        # read the magnitudes' bit patterns; 15 candidate compares each
        return {"bytes": plane, "int_ops": 16.0 * d, "flops": 0.0}
    if kernel == "topk_descent":
        # the k-th largest magnitude: one read of the plane
        return {"bytes": plane, "int_ops": 1.0 * d, "flops": 0.0}
    raise KeyError(kernel)
