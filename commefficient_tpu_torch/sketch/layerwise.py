"""Layerwise Count-Sketch accumulation: the PyTorch twin of the JAX
package's ``sketch/layerwise.py``. Each parameter leaf's gradient folds
straight into the running ``r x c`` table, so the flat [d] gradient and its
per-client stacks never exist:

    table = 0
    for leaf in leaves:                    # ravel order
        accumulate_leaf(spec, table, leaf, offset(leaf))

(on the card, one launch of a kernel folds the whole loop).

Block plan
----------

``make_block_plan(spec, layout)`` fixes, once per model, each leaf's place:
its global offset in ravel order (the ``FlatLayout``'s offsets, which are
``ravel_pytree``'s), its size, and for the rotation family the slab range
it touches (``s0``, ``num_slabs``, ``front``). The hashes stay derived from
the seed: a leaf reads the whole vector's per-(row, slab) shifts and signs
the global index of each coordinate.

Bit-parity contract
-------------------

``sketch_tree(spec, leaves)`` equals ``csvec.sketch_vec(spec, cat(leaves))``
bitwise, for both hash families:

- rotation: each bucket of each row receives one term per slab, and the
  whole-vector sketch adds them in slab order to a +0 start
  (``csvec._sketch_vec_rotation``'s explicit fold, and the kernel's fold
  in registers). ``accumulate_leaf`` continues that fold through the
  running table: the leaves come in ravel order, so each bucket still
  receives its terms in slab order, each exactly once. The plain version
  pads the leaf's slab range with zeros, and a padded position adds an
  exact ±0.0, which IEEE addition ignores (a sum started at +0 is never
  -0.0); the CUDA kernel (``kernels.accumulate_tree``) folds a whole
  tree's terms in that same order and skips those positions, which is the
  same.
- random: ``index_put_(accumulate=True)`` adds colliding entries in
  coordinate order onto the running table, the sequence the whole-vector
  scatter makes at ``num_blocks == 1``. ``num_blocks > 1`` sums per-block
  partial tables, another association, so the engine refuses layerwise
  there.

On a CUDA table the rotation family launches the ``sketch_accumulate_tree``
kernel: ``sketch_tree`` folds the whole tree into a fresh table in one
launch (one per ``kernels.TREE_MAX_LEAVES`` leaves), ``accumulate_leaf``
folds its one leaf in place. On a CPU table the plain per-leaf fold runs;
it is the kernel's plain version. The random family is plain on both, as
its whole-vector scatter is.

The reference's ``apply_delta_tree`` (the sparse delta applied per leaf) is
not needed here: the port's server state holds one flat [d] params vector,
and ``modes.apply_delta`` on it is what the per-leaf apply computes (the
reference pins the two bitwise, tests/test_layerwise.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from ..models.convert import FlatLayout
from ..obs import trace as obtrace
from . import kernels
from .csvec import CSVecSpec, _block_hashes, _rotation_keys, scatter_add_ordered, zero_table
from .hashing import row_keys, sign_hash, slab_shifts


@dataclasses.dataclass(frozen=True)
class LeafBlock:
    """Placement of one leaf in the raveled [d] order."""

    offset: int  # global index of the leaf's first coordinate
    size: int
    # rotation family: the slab range [s0, s0 + num_slabs) the leaf's
    # coordinates fall into, and the leaf's position within slab s0
    s0: int
    num_slabs: int
    front: int


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """The per-leaf plan of a model, in ravel order."""

    spec: CSVecSpec
    blocks: tuple[LeafBlock, ...]

    @property
    def d(self) -> int:
        return self.blocks[-1].offset + self.blocks[-1].size if self.blocks else 0


def _leaf_block(spec: CSVecSpec, offset: int, n: int) -> LeafBlock:
    """The one place slab placement is derived from (offset, size)."""
    s0 = offset // spec.c
    s1 = (offset + n - 1) // spec.c
    return LeafBlock(offset=offset, size=n, s0=s0, num_slabs=s1 - s0 + 1,
                     front=offset - s0 * spec.c)


def leaf_segments(tree: FlatLayout | Iterable[torch.Tensor]) -> tuple[tuple[int, int], ...]:
    """(offset, size) of every non-empty leaf in ravel order, of a model's
    ``FlatLayout`` or of a sequence of leaves laid end to end. The block
    plan and the per-leaf quarantine (``quarantine_scope="layer"``) both
    take their leaf boundaries from here, so they cannot disagree."""
    if isinstance(tree, FlatLayout):
        return tuple((leaf.offset, leaf.size) for leaf in tree.leaves if leaf.size)
    segs, off = [], 0
    for leaf in tree:
        if leaf.numel():
            segs.append((off, leaf.numel()))
            off += leaf.numel()
    return tuple(segs)


def make_block_plan(spec: CSVecSpec, tree: FlatLayout | Iterable[torch.Tensor]) -> BlockPlan:
    """The plan of a model's ``FlatLayout`` (or of a sequence of leaves)."""
    blocks = tuple(_leaf_block(spec, off, n) for off, n in leaf_segments(tree))
    covered = blocks[-1].offset + blocks[-1].size if blocks else 0
    if covered != spec.d:
        raise ValueError(
            f"block plan covers {covered} coordinates but the sketch spec has d={spec.d}: "
            "the plan must be built from the same model the round sketches")
    return BlockPlan(spec=spec, blocks=blocks)


def _accumulate_leaf_rotation(spec: CSVecSpec, table: torch.Tensor, v: torch.Tensor,
                              blk: LeafBlock) -> torch.Tensor:
    """Plain version: fold the leaf's [n] coordinates into the running table
    in place, continuing ``csvec._sketch_vec_rotation``'s slab-order left
    fold row by row. The leaf sits in a zero-padded buffer of its slab
    range, so positions owned by other leaves (or past d) add exact zeros.
    The fold is explicit: a ``.sum(0)`` over the slabs would reduce as a
    tree and lose bitwise parity."""
    c = spec.c
    buf = torch.zeros(blk.num_slabs * c, dtype=v.dtype, device=v.device)
    buf[blk.front:blk.front + blk.size] = v
    idx = blk.s0 * c + torch.arange(blk.num_slabs * c, dtype=torch.int64, device=v.device)
    _, ks = row_keys(spec.seed, spec.r, v.device)
    shifts = slab_shifts(spec.seed, spec.r, spec.num_slabs, c).tolist()
    for j in range(spec.r):
        signed = (buf * sign_hash(idx, ks[j], dtype=v.dtype)).reshape(blk.num_slabs, c)
        acc = table[j]
        for s in range(blk.num_slabs):
            acc = acc + torch.roll(signed[s], shifts[j][blk.s0 + s])
        table[j] = acc
    return table


def _accumulate_leaf_random(spec: CSVecSpec, table: torch.Tensor, v: torch.Tensor,
                            blk: LeafBlock) -> torch.Tensor:
    """Scatter-add the leaf's contributions onto the running table in place,
    in coordinate order: the per-bucket sequence of ``csvec._accumulate``'s
    whole-vector scatter at num_blocks == 1 (``csvec.scatter_add_ordered``
    adds colliding entries in index order on the CPU, in a fixed order on
    the GPU)."""
    idx = blk.offset + torch.arange(blk.size, dtype=torch.int64, device=v.device)
    buckets, signs = _block_hashes(spec, idx, v.dtype)
    contrib = signs * v[None, :]
    for j in range(spec.r):
        scatter_add_ordered(table[j], buckets[j], contrib[j])
    return table


def _accumulate(spec: CSVecSpec, table: torch.Tensor, v: torch.Tensor,
                blk: LeafBlock) -> torch.Tensor:
    """Fold one leaf into the running table in place: the tree kernel with
    one leaf for a CUDA table (rotation family), else the plain fold."""
    kernels.check_untransformed("leaf", v)
    if spec.family == "rotation":
        if table.is_cuda:
            shifts, ks = _rotation_keys(spec, table.device)
            return kernels.accumulate_tree(table, [v.contiguous()], [blk.offset], shifts, ks,
                                           spec.c, spec.d)
        return _accumulate_leaf_rotation(spec, table, v, blk)
    return _accumulate_leaf_random(spec, table, v, blk)


def accumulate_leaf(spec: CSVecSpec, table: torch.Tensor, leaf: torch.Tensor,
                    offset: int) -> torch.Tensor:
    """Fold one leaf, the global coordinates [offset, offset + n) in ravel
    order (any shape, read row-major), into the running [r, c] table in
    place, and return the table. Rotation family: one launch of the tree
    kernel for a CUDA table, else the plain fold."""
    v = leaf.reshape(-1)
    n = v.shape[0]
    if offset < 0 or n == 0 or offset + n > spec.d:
        raise ValueError(f"leaf block [{offset}, {offset + n}) falls outside d={spec.d}")
    if tuple(table.shape) != spec.table_shape:
        raise ValueError(f"expected table {spec.table_shape}, got {tuple(table.shape)}")
    return _accumulate(spec, table, v, _leaf_block(spec, offset, n))


@obtrace.spanned("federated", "sketch.accumulate")
def sketch_tree(spec: CSVecSpec, leaves: Iterable[torch.Tensor],
                plan: BlockPlan | None = None) -> torch.Tensor:
    """Sketch a model's leaves, given in ravel order (any shape each, read
    row-major; a generator is consumed once), into a fresh [r, c] table:
    equal bitwise to ``csvec.sketch_vec`` of their concatenation (rotation
    family at any num_blocks, random family at num_blocks == 1). The leaves
    may be views of one buffer or separate tensors. Rotation family on the
    card: one ``kernels.accumulate_tree`` call over the whole tree into an
    uninitialised table; else leaf by leaf. Without a plan the leaves'
    sizes make one."""
    flat = [leaf if leaf.dim() == 1 else leaf.reshape(-1) for leaf in leaves if leaf.numel()]
    if plan is None:
        plan = make_block_plan(spec, flat)
    if len(flat) != len(plan.blocks):
        raise ValueError(f"{len(flat)} non-empty leaves but the plan covers "
                         f"{len(plan.blocks)}")
    for v, blk in zip(flat, plan.blocks):
        if v.shape[0] != blk.size:
            raise ValueError(f"leaf at offset {blk.offset} has {v.shape[0]} coordinates, the "
                             f"plan says {blk.size}: a plan of another model")
    if not flat:
        return None
    device = flat[0].device
    if spec.family == "rotation" and device.type == "cuda":
        shifts, ks = _rotation_keys(spec, device)
        table = torch.empty(spec.table_shape, dtype=torch.float32, device=device)
        return kernels.accumulate_tree(table, [v.contiguous() for v in flat],
                                       [blk.offset for blk in plan.blocks], shifts, ks, spec.c,
                                       spec.d, fresh=True)
    table = zero_table(spec, device, flat[0].dtype)
    for v, blk in zip(flat, plan.blocks):
        _accumulate(spec, table, v, blk)
    return table
