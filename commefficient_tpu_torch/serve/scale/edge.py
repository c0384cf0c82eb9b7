"""Two-tier edge aggregation (``--serve_edges E``; the port's copy of the
JAX package's ``serve/scale/edge.py``): shard-local ordered table sums, one
partial per edge.

FetchSGD's linearity (the sketch of a sum is the sum of the sketches) makes
a two-level sum exact in real arithmetic: an edge aggregator sums its
shard's validated [r, c] tables and forwards one partial to the root, which
takes E partials in place of W tables. In float32 the two-level sum is
another association than the flat one, so an edge-armed session
(``serve_edges`` E >= 2) merges through the same two-level fold on both
serving paths: the grouped flat twin (``modes.edge_grouped_sum``, the
per-edge partials folded over the full stack) and the partials root
(``modes.merge_edge_partials``). Each ``EdgeAggregator`` here runs one lane
of that fold over its shard, in cohort-position order, with the same adds,
so the tree is bitwise the flat twin of the same session.

What crosses the tree a round, per edge: the partial, the shard's masks,
and each client's wire-formula L2 norm (``table_norms_host``, float64
accumulation, the formula the ingest validation screens with). A norm is
per client, so an edge computes the value the root would; the root's merge
screens the quarantine against the forwarded norms, and the screen cannot
differ between the flat twin and the tree.

A robust ``--merge_policy`` ranks per-client tables, which a summed partial
has lost: the tree then runs in forward mode, each edge forwarding its
shard's tables unsummed, and the root runs the plain robust merge.

An edge that dies (the ``edge_kill`` fault kind) forwards a zero partial
under zero masks: bitwise its shard's clients dropped, and the requeue
serves them later.

Numpy and the standard library only, like ``shard.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...obs import registry as obreg
from ...obs import trace as obtrace
from .shard import shard_for


def assign_edges(client_ids, n_edges: int) -> np.ndarray:
    """The [W] int32 edge of each cohort position: the client-id hash the
    sharded ingest routes by (``shard_for``), so ingest shard k and edge k
    own the same clients."""
    return np.asarray(shard_for(np.asarray(client_ids, np.int64), n_edges), np.int32)


def table_norms_host(tables) -> np.ndarray:
    """The [W] float32 L2 norm of each client's table, accumulated in
    float64: the formula of the ingest validation's screen
    (``serve/ingest._screen_table``), row by row. Each norm depends on its
    own table only, so any partition of the stack gives the same values."""
    t = np.asarray(tables, np.float32)
    if t.shape[0] == 0:
        return np.zeros(0, np.float32)  # an edge may own no invitee
    return np.sqrt(np.square(t, dtype=np.float64).reshape(t.shape[0], -1).sum(axis=1)
                   ).astype(np.float32)


def screen_mask(norms, clip_multiple: float, median: float) -> np.ndarray:
    """[W] float32, 1 kept and 0 quarantined: the host mirror of the merge
    step's ``_quarantine_mask`` over the same float32 norms and median, the
    threshold's product rounded in float32 as the step rounds it, so the
    edge's mask and the root's agree on a norm that sits on the threshold."""
    norms = np.asarray(norms, np.float32)
    bad = ~np.isfinite(norms)
    if clip_multiple > 0 and median > 0:
        thresh = np.float32(clip_multiple) * np.float32(median)
        bad = bad | (norms > thresh)
    return (~bad).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class EdgeReport:
    """What one edge forwards to the root for one round."""

    edge: int
    positions: np.ndarray        # the cohort positions the edge owns, ascending
    partial: np.ndarray | None   # the [r, c] summed table (None in forward mode)
    tables: np.ndarray | None    # the [W_e, r, c] stack (forward mode only)
    norms: np.ndarray            # [W_e] wire-formula L2 norms
    live: np.ndarray             # [W_e] the masks the fold used
    live_count: int
    weight_sum: float


def _shard_fold(tables, live) -> np.ndarray:
    """One edge's ordered sum: a left fold in cohort-position order in which
    a live row adds its table and a dead row adds an exact zero. Float32
    adds of the same values in the same order give the same bits in numpy
    and in the merge step, so this is one lane of
    ``modes.edge_grouped_sum``, bitwise. The zero is selected, never a
    product of the mask, so a NaN table in a dead row contributes zero."""
    tables = np.asarray(tables, np.float32)
    live = np.asarray(live, np.float32)
    acc = np.zeros(tables.shape[1:], np.float32)
    zero = np.zeros_like(acc)
    for i in range(tables.shape[0]):
        # a dead row adds its zero instead of being skipped: the step's lane
        # adds it too, and -0.0 + 0.0 is +0.0
        acc = acc + (tables[i] if live[i] > 0 else zero)
    return acc


class EdgeAggregator:
    """One edge: the cohort positions whose client ids hash to it. It
    screens and sums their tables in cohort-position order (``_shard_fold``),
    or forwards them unsummed in forward mode."""

    def __init__(self, edge: int, table_shape: tuple, forward_tables: bool = False):
        self.edge = edge
        self.table_shape = tuple(table_shape)
        self.forward_tables = forward_tables

    def aggregate(self, positions, tables, base_live, screen: tuple | None = None) -> EdgeReport:
        """One round's work on the shard: the norms, the quarantine screen
        before the fold (``screen`` is (clip multiple, median), the round's
        baseline; None with the quarantine off), then the ordered sum, or
        the stack in forward mode."""
        positions = np.asarray(positions, np.int64)
        tables = np.asarray(tables, np.float32)
        live = np.asarray(base_live, np.float32)
        norms = table_norms_host(tables)
        if screen is not None:
            live = live * screen_mask(norms, screen[0], screen[1])
        if self.forward_tables:
            partial, stack = None, tables
        else:
            partial, stack = _shard_fold(tables, live), None
        return EdgeReport(edge=self.edge, positions=positions, partial=partial, tables=stack,
                          norms=norms, live=live, live_count=int((live > 0).sum()),
                          weight_sum=float(live.sum()))


class EdgeTree:
    """The round's two-tier topology: the cohort partitioned over E edges
    by client-id hash, each edge's screen and sum, and the root's inputs:
    the [E, r, c] partials in edge order, the [W] norms and the [W]
    assignment.

    ``forward_tables`` (a robust merge policy): the edges forward their
    stacks, which the serving layer reassembles into the [W, r, c] stack.

    ``kill(edge)`` marks an edge dead for the current round (``edge_kill``):
    it forwards a zero partial under zero masks, and the serving layer
    zeroes its clients' arrival, so the requeue serves them later."""

    def __init__(self, n_edges: int, table_shape: tuple, forward_tables: bool = False):
        if n_edges < 2:
            raise ValueError(f"n_edges must be >= 2, got {n_edges} (one edge IS the flat merge)")
        self.n_edges = n_edges
        self.table_shape = tuple(table_shape)
        self.forward_tables = forward_tables
        self.edges = [EdgeAggregator(e, table_shape, forward_tables) for e in range(n_edges)]
        self._dead: set[int] = set()
        self.registry = obreg.default()

    def kill(self, edge: int) -> None:
        if not 0 <= edge < self.n_edges:
            raise ValueError(f"edge {edge} out of range [0, {self.n_edges})")
        self._dead.add(edge)
        self.registry.counter("serve_edge_deaths_total").inc()
        obtrace.instant("serve-edge", "edge:killed", edge=edge)

    def revive_all(self) -> None:
        self._dead.clear()

    @property
    def dead_edges(self) -> tuple:
        return tuple(sorted(self._dead))

    def dead_positions(self, ids) -> np.ndarray:
        """The cohort positions the dead edges own, whose arrival the
        serving layer zeroes."""
        assign = assign_edges(ids, self.n_edges)
        return np.flatnonzero(np.isin(assign, list(self._dead)))

    def aggregate_round(self, rnd: int, ids, tables, base_live, screen: tuple | None = None):
        """The tier's work on one closed round. ``tables`` is the close's
        [W, r, c] validated stack, ``base_live`` the [W] masks before the
        screen (participation times arrival, the dead edges' clients already
        zero); each edge screens its shard against ``screen`` ((clip
        multiple, median) or None) and folds it. Returns (the reports, the
        root's inputs {"assign", "norms", "partials"}; partials None in
        forward mode)."""
        ids = np.asarray(ids, np.int64)
        tables = np.asarray(tables, np.float32)
        base_live = np.asarray(base_live, np.float32)
        assign = assign_edges(ids, self.n_edges)
        norms = np.zeros(len(ids), np.float32)
        partials = (None if self.forward_tables
                    else np.zeros((self.n_edges,) + self.table_shape, np.float32))
        reports = []
        for edge in self.edges:
            pos = np.flatnonzero(assign == edge.edge)
            if edge.edge in self._dead:
                # a dead edge forwards nothing: a zero partial, zero masks,
                # and its clients' norms never reach the root
                reports.append(EdgeReport(
                    edge=edge.edge, positions=pos, partial=None, tables=None,
                    norms=np.zeros(len(pos), np.float32), live=np.zeros(len(pos), np.float32),
                    live_count=0, weight_sum=0.0))
                continue
            rep = edge.aggregate(pos, tables[pos], base_live[pos], screen)
            reports.append(rep)
            norms[pos] = rep.norms
            if partials is not None:
                partials[edge.edge] = rep.partial
        self.registry.counter("serve_edge_partials_total").inc(
            sum(1 for r in reports if r.partial is not None))
        if obtrace.get().enabled:
            obtrace.instant("serve-edge", "edge:round", round=int(rnd), edges=self.n_edges,
                            dead=len(self._dead), live=int(sum(r.live_count for r in reports)))
        return reports, {"assign": assign, "norms": norms, "partials": partials}

    def counters(self) -> dict:
        """The ``/metrics`` JSON ``edge`` block."""
        return {
            "n_edges": self.n_edges,
            "mode": "forward" if self.forward_tables else "partial",
            "dead": list(self.dead_edges),
            "deaths": int(self.registry.counter("serve_edge_deaths_total").value),
            "partials": int(self.registry.counter("serve_edge_partials_total").value),
        }
