"""Count-Sketch of a length-``d`` vector into an ``r x c`` table.

The PyTorch twin of the JAX package's ``sketch/csvec.py``. A sketch is a
plain ``[r, c]`` float tensor; its static configuration lives in the
hashable ``CSVecSpec``. Hashes are computed on the fly from the seed
(``hashing.py``).

The rotation family's dense accumulate (``sketch_vec``) and all-coordinate
query (``query_all``) have hand-written CUDA kernels (``kernels.py``). Each
entry point routes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version beside it; the plain versions are also what the kernels are
checked against on the card.

Estimate semantics: the estimate of coordinate ``i`` is the lower median
(sorted element ``(r - 1) // 2``) over the rows of
``sign[row, i] * table[row, bucket[row, i]]``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from . import kernels
from .hashing import bucket_hash, row_keys, sign_hash, slab_shifts

FAMILIES = ("random", "rotation")


@dataclasses.dataclass(frozen=True)
class CSVecSpec:
    """Static configuration of a count-sketch. Hashable.

    ``family`` selects the bucket-hash family:

    - "random": murmur-mixed per-coordinate buckets; accumulate and query
      are scatter and gather.
    - "rotation": coordinate i of row j lands in bucket
      (i mod c + shift[j, i // c]) mod c, with per-(row, slab) random shifts
      and the same per-(row, coordinate) random signs. Within a slab of c
      consecutive coordinates the bucket map is a rotation, so the dense
      accumulate and query need no scatter.
    """

    d: int  # dimensionality of the sketched vector
    c: int  # number of columns (buckets per row)
    r: int  # number of rows (independent hash functions)
    num_blocks: int = 1  # chunks the d-axis to bound transient memory
    seed: int = 42
    family: str = "random"

    def __post_init__(self):
        if self.d <= 0 or self.c <= 0 or self.r <= 0 or self.num_blocks <= 0:
            raise ValueError(f"invalid CSVecSpec: {self}")
        if self.family not in FAMILIES:
            raise ValueError(f"unknown hash family {self.family!r}; expected {FAMILIES}")

    @property
    def block_size(self) -> int:
        return math.ceil(self.d / self.num_blocks)

    @property
    def padded_d(self) -> int:
        return self.block_size * self.num_blocks

    @property
    def table_shape(self) -> tuple[int, int]:
        return (self.r, self.c)

    @property
    def num_slabs(self) -> int:
        """c-sized slabs of the d-axis (the rotation family's unit)."""
        return math.ceil(self.d / self.c)


def zero_table(spec: CSVecSpec, device: torch.device | str = "cpu",
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(spec.table_shape, dtype=dtype, device=device)


def _block_hashes(spec: CSVecSpec, idx: torch.Tensor, dtype: torch.dtype):
    """buckets[r, n] (int64) and signs[r, n] for coordinate indices idx[n]."""
    kb, ks = row_keys(spec.seed, spec.r, idx.device)
    idx = idx.to(torch.int64)
    if spec.family == "rotation":
        shifts = slab_shifts(spec.seed, spec.r, spec.num_slabs, spec.c, idx.device)
        buckets = (idx % spec.c)[None, :] + shifts[:, idx // spec.c]
        buckets = buckets % spec.c
    else:
        buckets = bucket_hash(idx[None, :], kb[:, None], spec.c)
    signs = sign_hash(idx[None, :], ks[:, None], dtype=dtype)
    return buckets, signs


def _pad_to_slabs(spec: CSVecSpec, v: torch.Tensor) -> torch.Tensor:
    """[d] -> [num_slabs, c], zero-padded."""
    pad = spec.num_slabs * spec.c - spec.d
    return torch.nn.functional.pad(v, (0, pad)).reshape(spec.num_slabs, spec.c)


@functools.lru_cache(maxsize=64)
def _rotation_keys(spec: CSVecSpec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' hash inputs: shifts int32 [r, S] and sign keys as int32
    [r] holding the uint32 bit patterns. Computed once per (spec, device):
    the kernels only read them, and callers must not write them."""
    _, ks = row_keys(spec.seed, spec.r, device)
    shifts = slab_shifts(spec.seed, spec.r, spec.num_slabs, spec.c, device)
    ks32 = torch.where(ks >= 2**31, ks - 2**32, ks).to(torch.int32)
    return shifts.to(torch.int32).contiguous(), ks32.contiguous()


def _sketch_vec_rotation(spec: CSVecSpec, v: torch.Tensor) -> torch.Tensor:
    """Plain dense accumulate, rotation family: per row, sign the vector,
    roll each slab right by its shift, and add the slabs.

    The slab reduction is an explicit left fold in slab order starting from
    zeros, as in the reference: a ``.sum(0)`` reduces as a tree and loses
    bitwise parity with it (and with the kernel, which folds per bucket in
    the same order)."""
    v_slabs = _pad_to_slabs(spec, v)  # padded coordinates contribute 0
    idx = torch.arange(spec.num_slabs * spec.c, dtype=torch.int64, device=v.device)
    _, ks = row_keys(spec.seed, spec.r, v.device)
    shifts = slab_shifts(spec.seed, spec.r, spec.num_slabs, spec.c).tolist()
    rows = []
    for j in range(spec.r):
        signed = v_slabs * sign_hash(idx, ks[j], dtype=v.dtype).reshape(v_slabs.shape)
        acc = torch.zeros(spec.c, dtype=v.dtype, device=v.device)
        for s in range(spec.num_slabs):
            acc = acc + torch.roll(signed[s], shifts[j][s])
        rows.append(acc)
    return torch.stack(rows)


def _query_slab_rotation(spec: CSVecSpec, table: torch.Tensor, slab: int,
                         shifts: list, ks: torch.Tensor) -> torch.Tensor:
    """[c] estimates for slab ``slab``: per row, roll the table row left by
    the slab's shift and apply signs; then the lower median over rows."""
    idx = slab * spec.c + torch.arange(spec.c, dtype=torch.int64, device=table.device)
    per_row = torch.stack([
        sign_hash(idx, ks[j], dtype=table.dtype) * torch.roll(table[j], -shifts[j][slab])
        for j in range(spec.r)
    ])
    return torch.sort(per_row, dim=0).values[(spec.r - 1) // 2]


def _query_all_rotation(spec: CSVecSpec, table: torch.Tensor) -> torch.Tensor:
    """Plain all-coordinate query, rotation family."""
    _, ks = row_keys(spec.seed, spec.r, table.device)
    shifts = slab_shifts(spec.seed, spec.r, spec.num_slabs, spec.c).tolist()
    ests = [_query_slab_rotation(spec, table, s, shifts, ks)
            for s in range(spec.num_slabs)]
    return torch.cat(ests)[: spec.d]


def _accumulate(spec: CSVecSpec, vals: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Scatter (idx, vals) masked by ``valid`` into a fresh [r, c] table: the
    one scatter path shared by the random family's dense accumulate and by
    sparse sketching. ``index_put_(accumulate=True)`` sums colliding entries
    in a fixed order on the GPU too (it sorts by bucket), where
    ``index_add_`` adds them with atomics in whatever order they land, so
    two runs of one seed would differ."""
    buckets, signs = _block_hashes(spec, idx, vals.dtype)
    contrib = signs * (vals * valid.to(vals.dtype))[None, :]  # [r, n]
    table = torch.zeros(spec.table_shape, dtype=vals.dtype, device=vals.device)
    for j in range(spec.r):
        table[j].index_put_((buckets[j],), contrib[j], accumulate=True)
    return table


def _check_vec(spec: CSVecSpec, v: torch.Tensor) -> None:
    kernels.check_untransformed("v", v)
    if tuple(v.shape) != (spec.d,):
        raise ValueError(f"expected shape ({spec.d},), got {tuple(v.shape)}")


def sketch_vec(spec: CSVecSpec, v: torch.Tensor) -> torch.Tensor:
    """Sketch a dense [d] vector into an [r, c] table (CSVec.accumulateVec).
    Rotation family: the CUDA kernel for a CUDA tensor, else the plain fold."""
    _check_vec(spec, v)
    if spec.family == "rotation":
        if v.is_cuda:
            shifts, ks = _rotation_keys(spec, v.device)
            return kernels.accumulate(v, shifts, ks, spec.c)
        return _sketch_vec_rotation(spec, v)
    if spec.num_blocks == 1:
        idx = torch.arange(spec.d, dtype=torch.int64, device=v.device)
        return _accumulate(spec, v, idx, idx < spec.d)
    bs = spec.block_size
    v_pad = torch.nn.functional.pad(v, (0, spec.padded_d - spec.d))
    table = zero_table(spec, v.device, v.dtype)
    for b in range(spec.num_blocks):
        idx = b * bs + torch.arange(bs, dtype=torch.int64, device=v.device)
        table = table + _accumulate(spec, v_pad[b * bs:(b + 1) * bs], idx, idx < spec.d)
    return table


def sketch_sparse(spec: CSVecSpec, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Sketch a k-sparse vector given by (idx[k], vals[k]); equals
    ``sketch_vec`` of the scattered dense vector. Entries with idx < 0 or
    idx >= d are ignored, so callers can pad with idx = -1."""
    valid = (idx >= 0) & (idx < spec.d)
    return _accumulate(spec, vals, idx.clamp(0, spec.d - 1), valid)


def query(spec: CSVecSpec, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Estimate coordinates idx[m] from the table: lower median over the r
    rows of sign * table[row, bucket] (CSVec._findValues)."""
    buckets, signs = _block_hashes(spec, idx, table.dtype)
    rows = torch.arange(spec.r, device=table.device)[:, None]
    per_row = signs * table[rows, buckets]  # [r, m]
    return torch.sort(per_row, dim=0).values[(spec.r - 1) // 2]


def mask_transmitted(spec: CSVecSpec, V: torch.Tensor, E: torch.Tensor,
                     idx: torch.Tensor, vals: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FetchSGD's sketch-space masking: E -= sketch(vals at idx);
    V -= sketch(query(V, idx) at idx)."""
    E = E - sketch_sparse(spec, idx, vals)
    vvals = query(spec, V, idx)
    V = V - sketch_sparse(spec, idx, vvals)
    return V, E


def merge_tables(spec: CSVecSpec, tables: torch.Tensor) -> torch.Tensor:
    """Merge stacked sketch tables [S, r, c] into one [r, c] table: an
    ordered sum over the leading axis, table 0 first. The served payload
    round and its batch twin both merge through here, so they add in the
    same order."""
    if tables.dim() != 3 or tuple(tables.shape[1:]) != spec.table_shape:
        raise ValueError(f"expected stacked tables [S, {spec.r}, {spec.c}], got "
                         f"{tuple(tables.shape)}")
    out = tables[0]
    for i in range(1, tables.shape[0]):
        out = out + tables[i]
    return out


def query_all(spec: CSVecSpec, table: torch.Tensor) -> torch.Tensor:
    """Dense [d] vector of estimates for every coordinate. Rotation family:
    the CUDA kernel for a CUDA tensor, else the plain per-slab query."""
    kernels.check_untransformed("table", table)
    if tuple(table.shape) != spec.table_shape:
        raise ValueError(f"expected table {spec.table_shape}, got {tuple(table.shape)}")
    if spec.family == "rotation":
        if table.is_cuda:
            shifts, ks = _rotation_keys(spec, table.device)
            return kernels.query(table, shifts, ks, spec.d)
        return _query_all_rotation(spec, table)
    if spec.num_blocks == 1:
        return query(spec, table, torch.arange(spec.d, dtype=torch.int64, device=table.device))
    bs = spec.block_size
    blocks = []
    for b in range(spec.num_blocks):
        idx = b * bs + torch.arange(bs, dtype=torch.int64, device=table.device)
        blocks.append(query(spec, table, idx.clamp(0, spec.d - 1)))
    return torch.cat(blocks)[: spec.d]


def topk_abs(x: torch.Tensor, k: int, impl: str = "exact") -> torch.Tensor:
    """Indices of the k largest-|.| entries, in descending |x| with ties
    broken toward the lower index, as the reference's ``lax.top_k`` orders
    them (``torch.topk`` leaves ties unordered, and FetchSGD's first round,
    at lr 0, selects among d exact zeros). Each entry gets the unique int64
    key (bits of |x|) * 2**32 + (2**32 - 1 - index): the bits of a
    non-negative float32 order as the float does. Only the exact selection
    is ported; "approx" and "oversample" raise."""
    if impl != "exact":
        raise NotImplementedError(
            f"topk_impl={impl!r} is not ported; only 'exact' is")
    if x.numel() >= 1 << 32:
        raise ValueError(f"topk_abs takes fewer than 2**32 entries, got {x.numel()}")
    return _topk_by_key(x.abs().contiguous().view(torch.int32), k)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest float32 entries of x in descending
    order, ties broken toward the lower index, as ``jax.lax.top_k`` gives
    them: ``topk_abs``'s keys over the order-preserving int32 of each
    entry's bits (the non-sign bits of a negative float flipped), so -inf
    orders below every finite value."""
    bits = x.contiguous().view(torch.int32)
    idx = _topk_by_key(torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits), k)
    return x[idx], idx


def _topk_by_key(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest int32 keys, ties toward the lower index."""
    low = (1 << 32) - 1 - torch.arange(key.numel(), dtype=torch.int64, device=key.device)
    return torch.topk((key.to(torch.int64) << 32) | low, k).indices


# Single-shot unsketch ceiling: the [d] estimates transient is materialized
# when it fits in this many bytes (the reference's constant). The chunked
# slab scan the reference runs above it is not ported.
UNSKETCH_SINGLE_SHOT_BYTES = 1 << 30


def unsketch_topk(spec: CSVecSpec, table: torch.Tensor, k: int,
                  impl: str = "exact") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k heavy hitters by |estimate|: (idx[k] int64, vals[k])
    (CSVec.unSketch(k)), single-shot over the materialized estimates."""
    if k > spec.d:
        raise ValueError(f"k={k} > d={spec.d}")
    if spec.d * 4 > UNSKETCH_SINGLE_SHOT_BYTES:
        raise NotImplementedError(
            f"d={spec.d} needs the chunked unsketch scan, which is not ported")
    est = query_all(spec, table)
    top_idx = topk_abs(est, k, impl=impl)
    return top_idx, est[top_idx]


def to_dense(d: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Scatter (idx, vals) into a dense [d] vector; out-of-range entries
    (idx < 0 padding, idx >= d) contribute nothing."""
    safe = idx.clamp(0, d - 1)
    contrib = torch.where((idx >= 0) & (idx < d), vals, torch.zeros_like(vals))
    return torch.zeros(d, dtype=vals.dtype, device=vals.device).index_add_(0, safe, contrib)
