"""Cohort assembler: over-provisioned rounds that close at W-of-N (the
port's copy of the JAX package's ``serve/assembler.py``).

A round invites the full cohort the session sampled (N = num_workers) and
closes when the quorum W has arrived or the deadline passes, whichever is
first. Every invitee that missed the close (a straggler after the W-th
arrival or past the deadline, a no-show) is masked out of the round and
re-queued through the session's requeue, so a short cohort is bitwise the
batch round over its survivors.

Two close disciplines:

- virtual (the in-process traffic): arrivals carry simulated latencies;
  sort by (latency, client_id), the W-th latency is the close, and
  everything at or under min(close, deadline) is in. Deterministic.
- wall (external socket clients): block on the ingest queue for quorum or
  timeout; receive order decides the cut.

A payload round's close also collects the validated [N, r, c] table stack
(``ClosedRound.tables``): each invitee's table where it passed the
validation and made the close, an exact zero row everywhere else. With
``--serve_fastpath`` (``ring_mode``) the accepted tables already lie in the
round's ring block, so the close builds no host stack (``tables`` is None)
and the service builds the device stack from the ring.

The buffered-async service (``--serve_async``) closes the same way with
the quorum read as the buffer-size trigger (``buffered``: the close is
named "buffer"), and the validated tables that arrived after the cut ride
on the ClosedRound (``straggler_tables``, in cohort-position order) for
the service to fold into a later merge.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..obs import registry as obreg
from ..obs import trace as obtrace
from .ingest import IngestQueue


@dataclasses.dataclass(frozen=True)
class ClosedRound:
    """One closed round: the invite list, who made the cut, the close's
    bookkeeping and (payload rounds) the validated table stack."""

    rnd: int
    invited: np.ndarray         # [N] int64 cohort (session.sample_cohort)
    arrived: np.ndarray         # [N] float32 0/1: made the W-of-N close
    latencies: np.ndarray       # [N] float64 submission latency (inf = none)
    closed_by: str              # "quorum" | "buffer" | "deadline"
    close_latency_s: float      # virtual close time (the W-th arrival's latency)
    stragglers: int             # submitted, but after the close
    no_shows: int               # never submitted
    # [N] float64 host accept times (perf_counter; inf = never accepted)
    wall_ts: np.ndarray | None = None
    # payload rounds: [N, r, c] float32 validated tables aligned with
    # ``invited``, a zero row wherever a payload missed the merge; None on
    # the announce path and with the fast path's ring
    tables: np.ndarray | None = None
    # buffered closes only: (cohort position, client id, table) of each
    # invitee whose validated table arrived after the cut, in position
    # order; () otherwise
    straggler_tables: tuple = ()

    @property
    def survivors(self) -> int:
        return int(self.arrived.sum())


class CohortAssembler:
    def __init__(self, queue: IngestQueue, quorum: int, deadline_s: float,
                 payload_shape: tuple | None = None, buffered: bool = False,
                 ring_mode: bool = False):
        if quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {quorum}")
        self.queue = queue
        self.quorum = quorum
        self.deadline_s = deadline_s
        # (r, c) of the payload tables; None = announce path
        self.payload_shape = payload_shape
        # the async service's buffer-size trigger: the same cut as the
        # quorum's, named "buffer", and the stragglers' tables collected
        self.buffered = buffered
        self.trigger_label = "buffer" if buffered else "quorum"
        # --serve_fastpath: the tables lie in the round's ring block, so the
        # close stacks none
        self.ring_mode = ring_mode
        self.rounds_closed = 0
        self.closed_by_quorum = 0
        self.closed_by_deadline = 0
        self.stragglers_total = 0
        self.no_shows_total = 0

    def close_virtual(self, rnd: int, invited) -> ClosedRound:
        """Close on simulated latencies: the accepted arrivals ranked by
        (latency, client_id); the quorum-th latency, capped at the
        deadline, is the close."""
        arrivals = self.queue.close_round(rnd)
        invited = np.asarray(invited, np.int64)
        pos = {int(c): i for i, c in enumerate(invited)}
        lat = np.full(len(invited), np.inf)
        walls = np.full(len(invited), np.inf)
        for a in arrivals:
            if int(a.client_id) in pos:
                lat[pos[int(a.client_id)]] = a.latency_s
                walls[pos[int(a.client_id)]] = a.wall_t
        order = np.lexsort((invited, lat))  # latency, then client id
        n_in_time = int((lat[order] <= self.deadline_s).sum())
        if n_in_time >= self.quorum:
            close = float(lat[order][self.quorum - 1])
            closed_by = self.trigger_label
        else:
            close = self.deadline_s
            closed_by = "deadline"
        arrived = (lat <= close).astype(np.float32)
        return self._finish(rnd, invited, arrived, lat, closed_by, close, walls,
                            self._collect_tables(pos, arrivals, arrived, len(invited)),
                            self._collect_stragglers(pos, arrivals, arrived))

    def close_wall(self, rnd: int, invited) -> ClosedRound:
        """Close on real arrival order: wait for quorum or deadline, then
        cut at the quorum-th arrival by receive order. The cut is decided on
        the snapshot the wait returned: submissions admitted between that
        instant and the drain are stragglers."""
        cut = self.queue.wait_for(self.quorum, self.deadline_s, rnd=rnd)
        arrivals = self.queue.close_round(rnd)
        invited = np.asarray(invited, np.int64)
        pos = {int(c): i for i, c in enumerate(invited)}
        lat = np.full(len(invited), np.inf)
        walls = np.full(len(invited), np.inf)
        arrived = np.zeros(len(invited), np.float32)
        made_cut = sorted(cut, key=lambda a: a.recv_order)[:self.quorum]
        for a in arrivals:
            if int(a.client_id) in pos:
                lat[pos[int(a.client_id)]] = a.latency_s
                walls[pos[int(a.client_id)]] = a.wall_t
        for a in made_cut:
            if int(a.client_id) in pos:
                arrived[pos[int(a.client_id)]] = 1.0
        closed_by = self.trigger_label if len(cut) >= self.quorum else "deadline"
        close = (max((a.latency_s for a in made_cut), default=self.deadline_s)
                 if closed_by != "deadline" else self.deadline_s)
        return self._finish(rnd, invited, arrived, lat, closed_by, close, walls,
                            self._collect_tables(pos, arrivals, arrived, len(invited)),
                            self._collect_stragglers(pos, arrivals, arrived))

    def _collect_tables(self, pos, arrivals, arrived, n: int) -> np.ndarray | None:
        """The [N, r, c] validated-table stack of a payload round: rows
        copied into a zero array, so a rejected, late or missing payload is
        an exact zero row. None on the announce path and in ring mode."""
        if self.payload_shape is None or self.ring_mode:
            return None
        out = np.zeros((n,) + tuple(self.payload_shape), np.float32)
        copied = 0
        for a in arrivals:
            p = pos.get(int(a.client_id))
            if p is not None and arrived[p] == 1.0 and a.table is not None:
                out[p] = a.table
                copied += 1
        if copied:
            # the slow path's second host copy of a table (the decode made
            # the first)
            obreg.default().counter("serve_table_bytes_copied_total").inc(
                copied * int(np.prod(self.payload_shape)) * 4)
        return out

    def _collect_stragglers(self, pos, arrivals, arrived) -> tuple:
        """(position, client id, table) of every invitee whose validated
        table arrived but missed the cut, in position order: the async
        service's fold candidates. () unless ``buffered``."""
        if not self.buffered or self.payload_shape is None:
            return ()
        out = []
        for a in arrivals:
            p = pos.get(int(a.client_id))
            if p is not None and arrived[p] == 0.0 and a.table is not None:
                # a copy: an in-process table is a view into the session's
                # pinned host buffer of the round's client tables, or into
                # the round's ring block, either of which a straggler kept
                # for a later round would hold
                out.append((int(p), int(a.client_id), np.array(a.table, np.float32)))
        return tuple(sorted(out, key=lambda e: e[0]))

    def _finish(self, rnd, invited, arrived, lat, closed_by, close, walls,
                tables, straggler_tables: tuple = ()) -> ClosedRound:
        submitted = np.isfinite(lat)
        stragglers = int((submitted & (arrived == 0.0)).sum())
        no_shows = int((~submitted).sum())
        self.rounds_closed += 1
        if closed_by != "deadline":
            self.closed_by_quorum += 1
        else:
            self.closed_by_deadline += 1
        self.stragglers_total += stragglers
        self.no_shows_total += no_shows
        obtrace.instant("assembler", f"close:{closed_by}", round=int(rnd),
                        survivors=int(arrived.sum()), stragglers=stragglers,
                        no_shows=no_shows)
        return ClosedRound(rnd=rnd, invited=invited, arrived=arrived, latencies=lat,
                           closed_by=closed_by, close_latency_s=float(close),
                           stragglers=stragglers, no_shows=no_shows, wall_ts=walls,
                           tables=tables, straggler_tables=straggler_tables)

    def counters(self) -> dict[str, int]:
        return {
            "rounds_closed": self.rounds_closed,
            "closed_by_quorum": self.closed_by_quorum,
            "closed_by_deadline": self.closed_by_deadline,
            "stragglers": self.stragglers_total,
            "no_shows": self.no_shows_total,
        }
