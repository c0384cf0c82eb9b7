"""ctypes wrappers for the CUDA sketch kernels (``csrc/sketch_kernels.cu``).

Each wrapper checks its inputs, allocates its output with ``torch.empty``
(``accumulate_leaf`` writes its table in place instead), launches on the
current CUDA stream without synchronising, raises if the launch reports an
error, and adds one to its launch count. They take CUDA
tensors only; the plain PyTorch versions the CPU path runs live in
``csvec.py`` and ``layerwise.py``.
"""

from __future__ import annotations

import torch

from . import _build

MAX_ROWS = 16

# launches per kernel since the last reset; a run reads these to show its
# main path went through the kernels
launch_counts = {"sketch_accumulate": 0, "sketch_query": 0, "sketch_accumulate_leaf": 0}


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


def accumulate_leaf(table: torch.Tensor, v_leaf: torch.Tensor, offset: int,
                    shifts: torch.Tensor, ks: torch.Tensor, c: int, d: int) -> torch.Tensor:
    """Rotation-family accumulate of one leaf, in place: fold the f32 [n]
    leaf, the coordinates [offset, offset + n) of a raveled [d] vector, into
    the running f32 [r, c] ``table`` and return it. The hashes are the whole
    vector's (``shifts`` int32 [r, S] with S = ceil(d / c), ``ks`` int32
    [r]): the sign of each global index, the shift of its slab. Folding a
    vector's leaves in order into a zero table gives ``accumulate`` of the
    vector, bitwise."""
    if v_leaf.dim() != 1 or table.dim() != 2 or c <= 0 or d <= 0:
        raise ValueError(f"need an [n] leaf, an [r, c] table, c > 0 and d > 0, got "
                         f"{tuple(v_leaf.shape)}, {tuple(table.shape)}, c={c}, d={d}")
    n, r = v_leaf.numel(), shifts.shape[0]
    if n < 1 or offset < 0 or offset + n > d:
        raise ValueError(f"leaf [{offset}, {offset + n}) must be non-empty and lie in [0, {d})")
    _check("v_leaf", v_leaf, torch.float32, (n,), v_leaf.device)
    _check("table", table, torch.float32, (r, c), v_leaf.device)
    _check_hashes(shifts, ks, r, -(-d // c), v_leaf.device)
    lib = _build.load()
    with torch.cuda.device(v_leaf.device):
        err = lib.sketch_accumulate_leaf(
            table.data_ptr(), v_leaf.data_ptr(), shifts.data_ptr(), ks.data_ptr(), offset, n,
            d, c, r, -(-d // c), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sketch_accumulate_leaf")
    launch_counts["sketch_accumulate_leaf"] += 1
    return table
