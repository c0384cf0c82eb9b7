"""A plain rotation-family Count-Sketch, worked out again from the seed, in
float64.

Hashes (FetchSGD's rotation family as the system defines it): per row j
(1-based in the key derivation) a bucket key and a sign key are murmur3
``fmix32`` finalisations of the row index times a stream constant, xored
with the 32-bit seed (the sign stream's seed is ``seed * 0x85EBCA6B + 1``).
Coordinate i of row j lands in bucket ``(i mod c + shift[j, i // c]) mod
c``, where ``shift[j, s] = fmix32(s ^ bucket_key[j]) mod c``, with sign
``1 - 2 * bit16(fmix32(i ^ sign_key[j]))``. A coordinate's estimate is the
lower median over the rows of sign * table[row, bucket].

Every operation here is a dense roll of c-long slabs, so nothing depends on
the order of a scatter.
"""

from __future__ import annotations

import dataclasses
import math

import torch

MASK32 = 0xFFFFFFFF
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
_BUCKET_STREAM, _SIGN_STREAM = 0x9E3779B9, 0x7FEB352D


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = (x * _C1) & MASK32
    x = x ^ (x >> 13)
    x = (x * _C2) & MASK32
    return x ^ (x >> 16)


@dataclasses.dataclass(frozen=True)
class Sketch:
    d: int
    c: int
    r: int
    seed: int

    @property
    def slabs(self) -> int:
        return math.ceil(self.d / self.c)

    def keys(self, device) -> tuple[torch.Tensor, list[list[int]]]:
        """(sign keys [r] int64, shifts as r lists of ``slabs`` ints)."""
        rows = torch.arange(1, self.r + 1, dtype=torch.int64, device=device)
        s32 = self.seed & MASK32
        kb = fmix32(((rows * _BUCKET_STREAM) & MASK32) ^ s32)
        ks = fmix32(((rows * _SIGN_STREAM) & MASK32) ^ ((s32 * _C1 + 1) & MASK32))
        slab = torch.arange(self.slabs, dtype=torch.int64, device=device)
        shifts = fmix32((slab[None, :] & MASK32) ^ kb[:, None]) % self.c
        return ks, shifts.tolist()

    def signs(self, ks_j: torch.Tensor, device) -> torch.Tensor:
        """[slabs, c] float64 signs of one row over the padded coordinates."""
        idx = torch.arange(self.slabs * self.c, dtype=torch.int64, device=device)
        bit = (fmix32(idx ^ ks_j) >> 16) & 1
        return (1 - 2 * bit).to(torch.float64).view(self.slabs, self.c)

    def sketch(self, v: torch.Tensor) -> torch.Tensor:
        """[r, c] float64 table of a dense [d] vector."""
        ks, shifts = self.keys(v.device)
        pad = self.slabs * self.c - self.d
        slabs = torch.nn.functional.pad(v.to(torch.float64), (0, pad)).view(self.slabs, self.c)
        rows = []
        for j in range(self.r):
            signed = slabs * self.signs(ks[j], v.device)
            acc = torch.zeros(self.c, dtype=torch.float64, device=v.device)
            for s in range(self.slabs):
                acc += torch.roll(signed[s], shifts[j][s])
            rows.append(acc)
        return torch.stack(rows)

    def estimates(self, table: torch.Tensor) -> torch.Tensor:
        """[d] float64 lower-median estimates of every coordinate."""
        ks, shifts = self.keys(table.device)
        per_row = torch.empty((self.r, self.slabs, self.c), dtype=torch.float64,
                              device=table.device)
        for j in range(self.r):
            rolled = torch.stack([torch.roll(table[j], -shifts[j][s])
                                  for s in range(self.slabs)])
            per_row[j] = rolled * self.signs(ks[j], table.device)
        est = torch.sort(per_row.view(self.r, -1), dim=0).values[(self.r - 1) // 2]
        return est[:self.d]
