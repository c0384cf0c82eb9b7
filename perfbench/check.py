"""The comparison that decides ``correct``: the system's first rounds
against the plain reference's, from the same seed, at the timed sizes.

The numbers; a cell's workload file names those it compares, each with
its limit:

- ``loss_gap``: the largest relative gap between the round losses;
  ``loss1_gap``: the first round's alone.
- ``grad_gap``: the first round's update as the server took it, by its
  worst leaf (in sketch mode: the rows of its sketch), the gap of the
  norms against the larger of the leaf's reference norm and the median
  leaf's.
- ``change_gap``: the parameters' change over the checked rounds, by its
  worst leaf in the same measure; ``change_median_gap``: the median
  leaf's gap.
  Leaves whose reference update is under a thousandth of the median
  leaf's are left out: they move by round-off alone (a key bias under
  softmax).
"""

from __future__ import annotations

import statistics

import torch

from .reference import layout as rlayout

KEEP_BELOW_MEDIAN = 1e-3


def gaps(prog: float, ref: float, floor: float) -> float:
    """The gap between two norms against the larger of the reference's norm
    and ``floor`` (the median leaf's)."""
    return abs(prog - ref) / max(ref, floor, 1e-30)


def worst_leaf_gap(prog_norms: list[float], ref_norms: list[float]) -> float:
    """The largest gap over the leaves, each against the larger of its own
    reference norm and the median leaf's."""
    med = statistics.median(ref_norms)
    return max(gaps(a, b, med) for a, b in zip(prog_norms, ref_norms))


def _leaf_gaps(prog: torch.Tensor, ref: torch.Tensor, p0: torch.Tensor, leaves: list,
               keep: list[bool]) -> list[tuple[float, str]]:
    """Per kept leaf, the gap of the norms of the two changes from ``p0``
    against the larger of the leaf's reference norm and the median kept
    leaf's, worst first, with the leaf's name."""
    a = rlayout.leaf_norms(prog.cpu().to(torch.float64) - p0, leaves)
    b = rlayout.leaf_norms(ref.cpu().to(torch.float64) - p0, leaves)
    med = statistics.median(n for n, k in zip(b, keep) if k)
    return sorted(((gaps(x, y, med), leaf.name) for x, y, k, leaf in zip(a, b, keep, leaves)
                   if k), reverse=True)


def numbers(model_cfg: dict, mode: str, prog: dict, ref: dict) -> dict:
    """Every number the check can compare (a cell's workload file names
    the ones it compares, with their limits), and the leaves behind the
    widest gaps."""
    leaves = rlayout.leaves(model_cfg)
    g_ref = rlayout.leaf_norms(ref["g1"], leaves)
    med = statistics.median(g_ref)
    keep = [n >= KEEP_BELOW_MEDIAN * med for n in g_ref]
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if mode == "sketch":
        grad = worst_leaf_gap([float(r.norm()) for r in prog["g1_table"]],
                              [float(r.norm()) for r in ref["g1_table"].cpu()])
    else:
        grad = worst_leaf_gap(rlayout.leaf_norms(prog["g1"].cpu(), leaves), g_ref)
    p0 = ref["p0"].cpu().to(torch.float64)
    last = _leaf_gaps(prog["p_last"], ref["p_last"], p0, leaves, keep)
    return {"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": grad,
            "change_gap": last[0][0], "change_median_gap": statistics.median(g for g, _ in last),
            "worst_leaves": [n for _, n in last[:2]],
            "left_out": [leaf.name for leaf, k in zip(leaves, keep) if not k]}


def compare(cell, prog: dict, ref: dict) -> dict:
    limits = cell.workload["limits"]
    nums = numbers(cell.model_cfg, cell.workload["mode"], prog, ref)
    return {k: {"value": nums[k], "limit": limit} for k, limit in limits.items()}
