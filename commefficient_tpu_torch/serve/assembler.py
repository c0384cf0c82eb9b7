"""Cohort assembler: over-provisioned rounds that close at W-of-N (the
port's copy of the JAX package's ``serve/assembler.py``, synchronous
closes only).

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
validation and made the close, an exact zero row everywhere else.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
    closed_by: str              # "quorum" | "deadline"
    close_latency_s: float      # virtual close time (the W-th arrival's latency)
    stragglers: int             # submitted, but after the close
    no_shows: int               # never submitted
    # [N] float64 host accept times (perf_counter; inf = never accepted)
    wall_ts: np.ndarray | None = None
    # payload rounds: [N, r, c] float32 validated tables aligned with
    # ``invited``, a zero row wherever a payload missed the merge; None on
    # the announce path
    tables: np.ndarray | None = None

    @property
    def survivors(self) -> int:
        return int(self.arrived.sum())


class CohortAssembler:
    def __init__(self, queue: IngestQueue, quorum: int, deadline_s: float,
                 payload_shape: tuple | None = None):
        if quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {quorum}")
        self.queue = queue
        self.quorum = quorum
        self.deadline_s = deadline_s
        # (r, c) of the payload tables; None = announce path
        self.payload_shape = payload_shape
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
            closed_by = "quorum"
        else:
            close = self.deadline_s
            closed_by = "deadline"
        arrived = (lat <= close).astype(np.float32)
        return self._finish(rnd, invited, arrived, lat, closed_by, close, walls,
                            self._collect_tables(pos, arrivals, arrived, len(invited)))

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
        closed_by = "quorum" if len(cut) >= self.quorum else "deadline"
        close = (max((a.latency_s for a in made_cut), default=self.deadline_s)
                 if closed_by != "deadline" else self.deadline_s)
        return self._finish(rnd, invited, arrived, lat, closed_by, close, walls,
                            self._collect_tables(pos, arrivals, arrived, len(invited)))

    def _collect_tables(self, pos, arrivals, arrived, n: int) -> np.ndarray | None:
        """The [N, r, c] validated-table stack of a payload round: rows
        copied into a zero array, so a rejected, late or missing payload is
        an exact zero row. None on the announce path."""
        if self.payload_shape is None:
            return None
        out = np.zeros((n,) + tuple(self.payload_shape), np.float32)
        for a in arrivals:
            p = pos.get(int(a.client_id))
            if p is not None and arrived[p] == 1.0 and a.table is not None:
                out[p] = a.table
        return out

    def _finish(self, rnd, invited, arrived, lat, closed_by, close, walls,
                tables) -> ClosedRound:
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
                           tables=tables)

    def counters(self) -> dict[str, int]:
        return {
            "rounds_closed": self.rounds_closed,
            "closed_by_quorum": self.closed_by_quorum,
            "closed_by_deadline": self.closed_by_deadline,
            "stragglers": self.stragglers_total,
            "no_shows": self.no_shows_total,
        }
