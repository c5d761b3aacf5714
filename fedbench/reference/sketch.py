"""The count sketch of FetchSGD (Rothchild et al., ICML 2020), with the
hash family re-derived from the seed, and the tie-inclusive top-k.

Geometry: ``c_pad`` is the column count rounded up to 128, ``T =
ceil(d / c_pad)``. A ``numpy.random.RandomState(seed)`` draws the shifts
``m = randint(0, c_pad, (r, T))`` and then the row keys ``randint(1, 2**31
- 1, (r,))``. Coordinate ``i`` lands in row ``j`` at column ``(i mod c_pad
+ m[j, i // c_pad]) mod c_pad`` with the sign ``+1`` where the murmur3
finalizer fmix32 of ``i XOR key_j`` is odd and ``-1`` where it is even.

Everything runs over blocks of coordinates, so a d of 10^8 fits beside
the tables.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_BLOCK = 1 << 23


def _mulmod32(x, m: int):
    """``x * m mod 2**32`` for ``0 <= x < 2**32`` in int64, by 16-bit
    halves of ``m`` so no product leaves the int64 range."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(x):
    """The murmur3 32-bit finalizer over int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mulmod32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


class CountSketch:
    """``r`` rows of ``c_pad`` columns over ``d`` coordinates."""

    def __init__(self, d: int, c: int, r: int, seed: int, device):
        self.d, self.r = int(d), int(r)
        self.c_pad = -(-int(c) // 128) * 128
        self.T = max(1, -(-self.d // self.c_pad))
        rs = np.random.RandomState(int(seed))
        m = rs.randint(0, self.c_pad, size=(self.r, self.T))
        keys = rs.randint(1, 2**31 - 1, size=(self.r,))
        self.device = torch.device(device)
        self.shift = torch.as_tensor(m.astype(np.int64), device=self.device)
        self.keys = [int(k) for k in keys]

    def _hash(self, j: int, idx):
        col = (idx % self.c_pad + self.shift[j][idx // self.c_pad]) \
            % self.c_pad
        sign = (fmix32((idx ^ self.keys[j]) & _MASK) & 1).to(
            torch.float32) * 2 - 1
        return col, sign

    def _blocks(self):
        for a in range(0, self.d, _BLOCK):
            yield torch.arange(a, min(a + _BLOCK, self.d),
                               device=self.device, dtype=torch.int64)

    def sketch(self, v: torch.Tensor) -> torch.Tensor:
        """The ``(r, c_pad)`` table of a ``(d,)`` vector."""
        table = torch.zeros(self.r, self.c_pad, device=self.device)
        for idx in self._blocks():
            x = v[idx[0]:idx[-1] + 1].float()
            for j in range(self.r):
                col, sign = self._hash(j, idx)
                table[j].index_add_(0, col, sign * x)
        return table

    def query(self, table: torch.Tensor) -> torch.Tensor:
        """The median over the rows of each coordinate's signed cell,
        ``(d,)`` (the mean of the middle two for an even row count)."""
        out = torch.empty(self.d, device=self.device)
        for idx in self._blocks():
            est = torch.stack([table[j][col] * sign for j, (col, sign) in
                               enumerate(self._hash(j, idx)
                                         for j in range(self.r))])
            srt = torch.sort(est, dim=0).values
            mid = self.r // 2
            out[idx[0]:idx[-1] + 1] = (srt[mid] if self.r % 2 else
                                      0.5 * (srt[mid - 1] + srt[mid]))
        return out


def topk(v: torch.Tensor, k: int) -> torch.Tensor:
    """``v`` where ``|v|`` reaches its k-th largest magnitude, else 0
    (every coordinate tied at the cut is kept)."""
    mag = v.abs()
    if k >= v.numel():
        return v.clone()
    cut = torch.topk(mag, k, sorted=False).values.min()
    return torch.where(mag >= cut, v, torch.zeros((), device=v.device))
