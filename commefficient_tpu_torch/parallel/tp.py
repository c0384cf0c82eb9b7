"""Tensor-parallel layouts of GPT-2 over the mesh's ``model`` axis: the
port's twin of the JAX package's ``parallel/tp.py``.

Megatron's split, leaf by leaf, the assignment of the reference's
``gpt2_partition_specs``:

- column-parallel: ``c_attn`` and ``c_fc`` (weight and bias) split their
  output units. A torch ``nn.Linear`` weight is [out, in] where flax's
  kernel is [in, out], so the split is along axis 0 of the torch weight.
  ``c_attn``'s outputs split by head: each rank takes H / M heads of q, of
  k and of v (the values equal the reference's contiguous split of the
  [in, 3C] kernel, which GSPMD computes the same function from).
- row-parallel: ``c_proj``'s weight splits its input units (axis 1 of the
  torch weight); its bias is replicated and is added once, after the sum.
- expert-split: a mixture of experts' [E, ...] ``wi`` and ``wo`` split
  their experts, E / M to a rank.
- replicated: everything else, the router and ``c_proj``'s bias among
  them.

The port keeps the whole flat parameter vector on every rank, as the
server state is replicated over the model ranks; a rank computes with its
slices as views of the full leaves. The split is of compute and
activations, not of the server state. A rank's gradient is whole for the
replicated leaves and holds only its own slices of the split ones;
``TPPlan.gather_full`` builds the full flat vector from the ranks' slices,
exactly (copies, no sums).
"""

from __future__ import annotations

import dataclasses

import torch

from . import collectives

COLUMN, ROW, EXPERT, REPLICATED = "column", "row", "expert", "replicated"


def leaf_kind(name: str, ndim: int) -> str:
    """The split of the GPT-2 parameter ``name`` (the port's name) of
    ``ndim`` dimensions, as ``gpt2_partition_specs`` assigns it."""
    if ".moe_mlp." in name:
        return EXPERT if ndim == 3 else REPLICATED
    if ".c_attn." in name or ".c_fc." in name:
        return COLUMN
    if ".c_proj." in name:
        return ROW if name.endswith(".weight") else REPLICATED
    return REPLICATED


def gpt2_plan(model: torch.nn.Module) -> dict[str, str]:
    """{parameter name: its split} over a ``GPT2LMHead``'s parameters."""
    return {name: leaf_kind(name, p.dim()) for name, p in model.named_parameters()}


def check_divides(cfg, model_parallel: int) -> None:
    """Refuse a ``model_parallel`` that does not divide the heads, the MLP's
    hidden units or the experts, by name."""
    if model_parallel <= 1:
        return
    for what, n in (("n_head", cfg.n_head), ("4 * n_embd", 4 * cfg.n_embd),
                    *((("moe_experts", cfg.moe_experts),) if cfg.moe_experts else ())):
        if n % model_parallel:
            raise ValueError(f"--model_parallel {model_parallel} does not divide GPT-2's "
                             f"{what} ({n}): every model rank takes an equal share")


def columns(t: torch.Tensor, axis: collectives.Axis, parts: int = 1) -> torch.Tensor:
    """This rank's output units of a column-parallel weight [out, in] or bias
    [out]: ``parts`` equal sections (q, k and v for ``c_attn``), each split
    M ways, this rank's piece of each, in section order."""
    n = t.shape[0] // parts
    k = n // axis.size
    pieces = [t.narrow(0, j * n + axis.index * k, k) for j in range(parts)]
    return pieces[0] if parts == 1 else torch.cat(pieces)


def rows(w: torch.Tensor, axis: collectives.Axis) -> torch.Tensor:
    """This rank's input units of a row-parallel weight [out, in]."""
    k = w.shape[1] // axis.size
    return w.narrow(1, axis.index * k, k)


@dataclasses.dataclass(frozen=True)
class _Split:
    offset: int
    size: int
    shape: tuple  # the leaf in flax layout, as the flat vector holds it
    dim: int  # the split axis of ``shape``
    parts: int  # equal sections, each split M ways


class TPPlan:
    """Where a GPT-2's split leaves lie in its flat vector (a
    ``models.convert.FlatLayout``, flax layouts), and how to rebuild the
    full vector from the model ranks' slices."""

    def __init__(self, layout):
        self.splits: list[_Split] = []
        self.segments: list = []  # (offset, size, split or None) in flat order
        for leaf in layout.leaves:
            kind = leaf_kind(leaf.name, len(leaf.shape))
            if kind == REPLICATED:
                self.segments.append((leaf.offset, leaf.size, None))
                continue
            shape = leaf.flax_shape
            # flax layout: a kernel [in, out], a bias [out], an expert [E, ...]
            dim = {COLUMN: len(shape) - 1, ROW: 0, EXPERT: 0}[kind]
            parts = 3 if ".c_attn." in leaf.name else 1
            split = _Split(leaf.offset, leaf.size, shape, dim, parts)
            self.splits.append(split)
            self.segments.append((leaf.offset, leaf.size, split))

    @staticmethod
    def _piece(leaf: torch.Tensor, s: _Split, q: int, j: int, M: int) -> torch.Tensor:
        """Rank q's piece of section j of a leaf (in flax layout)."""
        k = s.shape[s.dim] // s.parts // M
        return leaf.narrow(s.dim, (j * M + q) * k, k)

    def gather_full(self, flat: torch.Tensor, axis: collectives.Axis) -> torch.Tensor:
        """The full flat [d] vector from ``flat``, whose replicated leaves
        are whole and whose split leaves hold this rank's slices: one
        gather of every rank's slices over the model group, then each slice
        placed where it belongs. Copies only: every rank gets the same
        bits. Runs under ``torch.func.vmap``."""
        M = axis.size

        def leaf(s):
            return flat.narrow(-1, s.offset, s.size).unflatten(-1, s.shape)

        own = torch.cat([self._piece(leaf(s), s, axis.index, j, M).reshape(-1)
                         for s in self.splits for j in range(s.parts)])
        stacked = collectives.stack(own, axis)  # [M, n]: every rank's slices
        shapes = [s.shape[:s.dim] + (s.shape[s.dim] // s.parts // M,) + s.shape[s.dim + 1:]
                  for s in self.splits for _ in range(s.parts)]
        sizes = [int(torch.Size(sh).numel()) for sh in shapes]
        per_rank = [torch.split(stacked[q], sizes) for q in range(M)]
        out, i = [], 0
        for off, size, s in self.segments:
            if s is None:
                out.append(flat.narrow(-1, off, size))
                continue
            pieces = [per_rank[q][i + j].reshape(shapes[i + j])
                      for j in range(s.parts) for q in range(M)]
            out.append(torch.cat(pieces, s.dim).reshape(-1))
            i += s.parts
        return torch.cat(out)
