"""ctypes wrappers for the CUDA sketch kernels (``csrc/sketch_kernels.cu``).

Each wrapper checks its inputs, allocates its output with ``torch.empty``
(``accumulate_tree`` writes the caller's table instead), launches on the
current CUDA stream without synchronising, raises if the launch reports an
error, and adds one to its launch count for each launch. They take CUDA
tensors only; the plain PyTorch versions the CPU path runs live in
``csvec.py`` and ``layerwise.py``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

MAX_ROWS = 16
# leaves a launch of the tree kernel takes: kTreeLeaves in
# csrc/sketch_kernels.cu (sketch_tree_max_leaves() of the built library)
TREE_MAX_LEAVES = 160

# launches per kernel since the last reset; a run reads these to show its
# main path went through the kernels
launch_counts = {"sketch_accumulate": 0, "sketch_query": 0, "sketch_accumulate_tree": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def check_untransformed(name: str, t: torch.Tensor) -> None:
    """Raise for a tensor of a ``torch.func`` transform (a vmap's batched
    tensor, a grad's wrapper): the sketch runs on whole tensors outside any
    transform, the engine calls it row by row, and no map may reach it."""
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        raise ValueError(f"{name} is a tensor of a torch.func transform (vmap or grad); the "
                         "sketch kernels take plain tensors, outside any transform")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    check_untransformed(name, t)
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_hashes(shifts: torch.Tensor, ks: torch.Tensor, r: int, num_slabs: int,
                  device: torch.device) -> None:
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"the sketch kernels take 1 <= r <= {MAX_ROWS}, got r={r}")
    _check("shifts", shifts, torch.int32, (r, num_slabs), device)
    _check("ks", ks, torch.int32, (r,), device)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def accumulate(v: torch.Tensor, shifts: torch.Tensor, ks: torch.Tensor,
               c: int) -> torch.Tensor:
    """Rotation-family accumulate: f32 [d] -> f32 [r, c] table.
    ``shifts`` int32 [r, S] with S = ceil(d / c); ``ks`` int32 [r] holding
    the uint32 sign keys."""
    if v.dim() != 1 or v.numel() == 0 or c <= 0:
        raise ValueError(f"need a non-empty [d] vector and c > 0, got {tuple(v.shape)}, c={c}")
    d, r = v.numel(), shifts.shape[0]
    num_slabs = -(-d // c)
    _check("v", v, torch.float32, (d,), v.device)
    _check_hashes(shifts, ks, r, num_slabs, v.device)
    out = torch.empty((r, c), dtype=torch.float32, device=v.device)
    lib = _build.load()
    with torch.cuda.device(v.device):  # launch on the tensors' device
        err = lib.sketch_accumulate(
            v.data_ptr(), shifts.data_ptr(), ks.data_ptr(), out.data_ptr(),
            d, c, r, num_slabs, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sketch_accumulate")
    launch_counts["sketch_accumulate"] += 1
    return out


def query(table: torch.Tensor, shifts: torch.Tensor, ks: torch.Tensor,
          d: int) -> torch.Tensor:
    """Rotation-family all-coordinate query: f32 [r, c] table -> f32 [d]
    lower-median estimates."""
    if table.dim() != 2 or d <= 0:
        raise ValueError(f"need an [r, c] table and d > 0, got {tuple(table.shape)}, d={d}")
    r, c = table.shape
    if c <= 0:
        raise ValueError("need c > 0")
    num_slabs = -(-d // c)
    _check("table", table, torch.float32, (r, c), table.device)
    _check_hashes(shifts, ks, r, num_slabs, table.device)
    out = torch.empty((d,), dtype=torch.float32, device=table.device)
    lib = _build.load()
    with torch.cuda.device(table.device):
        err = lib.sketch_query(
            table.data_ptr(), shifts.data_ptr(), ks.data_ptr(), out.data_ptr(),
            d, c, r, num_slabs, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sketch_query")
    launch_counts["sketch_query"] += 1
    return out


def tree_launches(n_leaves: int, cap: int = TREE_MAX_LEAVES) -> list[range]:
    """The leaves of each launch of the tree kernel: consecutive runs of at
    most ``cap`` leaves, in ravel order, ceil(n_leaves / cap) of them."""
    return [range(i, min(i + cap, n_leaves)) for i in range(0, n_leaves, cap)]


def accumulate_tree(table: torch.Tensor, leaves: Sequence[torch.Tensor],
                    offsets: Sequence[int], shifts: torch.Tensor, ks: torch.Tensor, c: int,
                    d: int, fresh: bool = False) -> torch.Tensor:
    """Rotation-family accumulate of a tree of leaves into the f32 [r, c]
    ``table``, which it returns: leaf m, an f32 [n_m] tensor, holds the
    coordinates [offsets[m], offsets[m] + n_m) of a raveled [d] vector.
    The leaves may be views or separate allocations; their ranges ascend,
    do not overlap and lie in [0, d), and a gap between them adds nothing.
    ``fresh`` starts from a +0 table (its contents are not read: it may be
    ``torch.empty``), else the fold continues the table in place. The hashes
    are the whole vector's (``shifts`` int32 [r, S] with S = ceil(d / c),
    ``ks`` int32 [r]). One launch per ``tree_launches`` group, each
    continuing the fold; the result equals the plain per-leaf fold in ravel
    order, and for a fresh table and leaves covering [0, d) ``accumulate``
    of the concatenation, bitwise."""
    if table.dim() != 2 or c <= 0 or d <= 0:
        raise ValueError(f"need an [r, c] table, c > 0 and d > 0, got {tuple(table.shape)}, "
                         f"c={c}, d={d}")
    if not leaves or len(leaves) != len(offsets):
        raise ValueError(f"need one offset per leaf and at least one leaf, got {len(leaves)} "
                         f"leaves and {len(offsets)} offsets")
    r = shifts.shape[0]
    _check("table", table, torch.float32, (r, c), table.device)
    _check_hashes(shifts, ks, r, -(-d // c), table.device)
    dev, past, ptrs, ends = table.device, 0, [], []
    for m, (leaf, off) in enumerate(zip(leaves, offsets)):
        check_untransformed("a leaf", leaf)
        if leaf.dim() != 1:
            raise ValueError(f"leaf {m} must be 1-D, got shape {tuple(leaf.shape)}")
        n = leaf.shape[0]
        if leaf.dtype != torch.float32 or leaf.device != dev or not leaf.is_contiguous():
            _check(f"leaf {m}", leaf, torch.float32, (n,), dev)
        if n < 1 or off < past or off + n > d:
            raise ValueError(f"leaf {m} [{off}, {off + n}) must be non-empty, lie in [0, {d}) "
                             f"and start at or after the previous leaf's end {past}")
        past = off + n
        ptrs.append(leaf.data_ptr())
        ends.append(past)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for group in tree_launches(len(leaves)):
            g = slice(group.start, group.stop)
            arr = (ctypes.c_int64 * (3 * len(group)))(*ptrs[g], *offsets[g], *ends[g])
            err = lib.sketch_accumulate_tree(
                table.data_ptr(), arr, len(group), shifts.data_ptr(), ks.data_ptr(), d, c, r,
                -(-d // c), int(fresh and group.start == 0), stream)
            _raise_on(err, "sketch_accumulate_tree")
            launch_counts["sketch_accumulate_tree"] += 1
    return table
