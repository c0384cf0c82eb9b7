"""Deterministic, stateless hash functions for the Count-Sketch.

The PyTorch twin of the JAX package's ``sketch/hashing.py``: the murmur3
32-bit finaliser over coordinate indices, keyed per row from one integer
seed, so every hash is rebuilt on the fly and no ``[r, d]`` hash tensor ever
exists.

torch's ``uint32`` lacks ``>>`` on the CPU, so every function here computes
in ``int64`` and masks with ``& 0xFFFFFFFF`` after each multiply, xor and
shift. An ``int64`` product of two 32-bit values wraps, but its low 32 bits
are the ``uint32`` product's, so the masked results equal the reference's
``uint32`` arithmetic exactly.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# murmur3 fmix32 constants
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
# distinct stream constants for deriving per-row keys
_BUCKET_STREAM = 0x9E3779B9
_SIGN_STREAM = 0x7FEB352D


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finaliser on values in [0, 2**32), held as int64."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = (x * _C1) & MASK32
    x = x ^ (x >> 13)
    x = (x * _C2) & MASK32
    x = x ^ (x >> 16)
    return x


def row_keys(seed: int, num_rows: int,
             device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row keys (bucket_keys[r], sign_keys[r]) as int64 in [0, 2**32)."""
    rows = torch.arange(1, num_rows + 1, dtype=torch.int64, device=device)
    seed32 = seed & MASK32
    kb = fmix32(((rows * _BUCKET_STREAM) & MASK32) ^ seed32)
    ks = fmix32(((rows * _SIGN_STREAM) & MASK32) ^ ((seed32 * _C1 + 1) & MASK32))
    return kb, ks


def bucket_hash(idx: torch.Tensor, bucket_key: torch.Tensor | int,
                num_cols: int) -> torch.Tensor:
    """Bucket in [0, num_cols) for coordinate indices ``idx`` (int64)."""
    h = fmix32((idx.to(torch.int64) & MASK32) ^ bucket_key)
    return h % num_cols


def slab_shifts(seed: int, num_rows: int, num_slabs: int, num_cols: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-(row, slab) rotation shifts in [0, num_cols), int64 [r, S]:
    coordinate i lands in bucket (i mod c + shifts[row, i // c]) mod c."""
    kb, _ = row_keys(seed, num_rows, device)
    slabs = torch.arange(num_slabs, dtype=torch.int64, device=device)
    return bucket_hash(slabs[None, :], kb[:, None], num_cols)


def sign_hash(idx: torch.Tensor, sign_key: torch.Tensor | int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Random sign in {-1, +1} for coordinate indices ``idx``."""
    h = fmix32((idx.to(torch.int64) & MASK32) ^ sign_key)
    bit = (h >> 16) & 1
    return (1 - 2 * bit).to(dtype)
