"""Ingest layer: admission control for client submissions (the port's
copy of the JAX package's ``serve/ingest.py``).

A bounded, thread-safe arrival queue with explicit admission decisions:
every submission is either ACCEPTED into an open round or rejected with a
reason the transport echoes back to the client (``QUEUE_FULL`` is the
backpressure signal a well-behaved client backs off on). The queue holds
per-round windows (up to ``MAX_OPEN_ROUNDS`` open at once, as in the
reference), each with its own invite list, arrival list and dedup set.

Admission rules, in check order:

- ``CLOSED``       — the service is shutting down.
- ``SHEDDING``     — the queue is past its pressure watermark
  (``--serve_shed_watermark``): turned away before any other work, with a
  retry-after hint on the socket wire. A retry of an already admitted
  submission still hears DUPLICATE (success).
- ``QUEUE_FULL``   — the round's window is at capacity.
- ``OUT_OF_ROUND`` — no open window for the named round. A push for the
  round after the newest window ever opened is ``BUFFERED`` in the
  bounded pending queue and admitted when that round opens (announce path
  only: a sketch payload is a function of its round's params, so a table
  for a round whose window never opened cannot exist yet). In the
  buffered-async band (``stale_rounds`` > 0) a payload for a round closed
  at most ``stale_rounds`` behind the newest window is admitted
  ``ACCEPTED_STALE`` into the bounded stale buffer instead, checked against
  that round's retained invite list, dedup set and quarantine median (not
  the newest round's), and the service folds it into a later merge.
- ``NOT_INVITED``  — the client is not in the round's cohort.
- ``DUPLICATE``    — the client already has an accepted submission for
  the round.

With a payload policy (``--serve_payload sketch``) an otherwise admissible
submission then runs ``validate_payload``, the one decode of untrusted
wire bytes: ``MALFORMED`` (structure, layout, length prefix, checksum, a
broken chunk sequence), ``STALE_SCHEMA`` (an unknown wire schema) or
``QUARANTINED`` (a non-finite table; with ``clip_multiple > 0``, which
``--client_update_clip`` arms, also a table whose L2 norm exceeds that
multiple of the round's quarantine median, the gauntlet's sketch-space
screen). A rejected payload is bitwise a client that never submitted.

With ``--serve_fastpath`` a payload round's decoded tables land straight
in the round's ring block (``attach_block``; ``serve/ring.py``: one write,
no table of its own), and over the socket the validation runs in batches
(``serve/gauntlet.py`` -> ``submit_block``): the frames' structural checks
one by one, then the finite and L2 screen over the block in one numpy pass
(``screen_block``). Verdicts, counters and the per-submission attribution
are bitwise the inline path's; ``validate_payload`` stays the one decode.

Counters are cumulative over the service's life and feed ``/metrics``;
the wire-facing rejections also bump process-wide counters in the obs
registry.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import sys
import threading
import time
import zlib
from typing import Any, Callable

import numpy as np

from ..obs import registry as obreg
from ..obs import trace as obtrace
from ..sketch.payload import MAX_CHUNKS, SCHEMA_VERSION, WIRE_DTYPE

# admission decisions (wire-visible: the socket transport echoes them)
ACCEPTED = "ACCEPTED"
CLOSED = "CLOSED"
QUEUE_FULL = "QUEUE_FULL"
OUT_OF_ROUND = "OUT_OF_ROUND"
NOT_INVITED = "NOT_INVITED"
DUPLICATE = "DUPLICATE"
BUFFERED = "BUFFERED"  # early submission parked for the next round
# buffered-async band: a late payload for a recently closed round, parked
# for a staleness-weighted fold into a later merge
ACCEPTED_STALE = "ACCEPTED_STALE"
MALFORMED = "MALFORMED"
STALE_SCHEMA = "STALE_SCHEMA"
QUARANTINED = "QUARANTINED"
SHEDDING = "SHEDDING"

# obs-registry counters of the wire-facing rejection classes
_REJECTION_COUNTERS = {
    MALFORMED: "serve_rejected_malformed_total",
    STALE_SCHEMA: "serve_rejected_stale_schema_total",
    QUARANTINED: "serve_rejected_quarantined_total",
    SHEDDING: "serve_shed_total",
    ACCEPTED_STALE: "serve_stale_admitted_total",
}
# windows open at once (the serial service opens one; the reference's
# pipelined service, not ported, two)
MAX_OPEN_ROUNDS = 2
# every decision also counts as serve_admission_<decision>_total
_ADMISSION_COUNTERS = {s: f"serve_admission_{s.lower()}_total" for s in (
    ACCEPTED, CLOSED, QUEUE_FULL, OUT_OF_ROUND, NOT_INVITED, DUPLICATE, BUFFERED, ACCEPTED_STALE,
    MALFORMED, STALE_SCHEMA, QUARANTINED, SHEDDING)}


@dataclasses.dataclass(frozen=True)
class Submission:
    """One client push. ``latency_s`` is the client's submission delay
    after the round's invite (simulated by the traffic generator); the
    assembler's virtual clock orders arrivals by it. ``payload`` is a
    sketch-carrying submission's wire payload: a raw [r, c] float32 ndarray
    in process, a frame dict (``sketch/payload.py``) or a list of chunk
    frames off the socket; None on the announce path."""

    client_id: int
    round: int
    latency_s: float = 0.0
    payload_bytes: int = 0
    payload: Any = None


@dataclasses.dataclass(frozen=True)
class Arrival:
    """An accepted submission, as the assembler sees it: ``recv_order`` is
    the wall arrival order, ``wall_t`` the host time of the accept (the
    start of its submission-to-merge latency), ``table`` the validated
    [r, c] table of a payload submission."""

    client_id: int
    latency_s: float
    recv_order: int
    wall_t: float = 0.0
    table: Any = None


@dataclasses.dataclass(frozen=True)
class StaleArrival:
    """A late payload admitted into the buffered-async band: the validated
    table and the round it answered, whose lag to the merge round fixes
    its weight."""

    round: int
    client_id: int
    latency_s: float
    recv_order: int
    wall_t: float
    table: Any


@dataclasses.dataclass(frozen=True)
class PayloadPolicy:
    """What the server demands of a wire payload: its own sketch spec's
    shape, and the quarantine screen (``clip_multiple`` > 0 times the live
    ``quarantine_median()``; 0 = the non-finite screen only)."""

    rows: int
    cols: int
    clip_multiple: float = 0.0
    quarantine_median: Callable[[], float] | None = None

    @property
    def nbytes(self) -> int:
        return self.rows * self.cols * 4  # float32 wire dtype


def _reassemble_chunks(payload):
    """Chunk-sequence reassembly, the first stage of ``validate_payload``
    for a list payload. Returns (frame, None, None), a single frame with
    chunk 0's header and the concatenated data, or (None, MALFORMED,
    detail) for a partial, reordered, duplicated, oversized or
    schema-mixed sequence."""
    if len(payload) == 0:
        return None, MALFORMED, "empty chunk sequence"
    if len(payload) > MAX_CHUNKS:
        return None, MALFORMED, f"{len(payload)} chunks > MAX_CHUNKS {MAX_CHUNKS}"
    if not all(isinstance(f, dict) for f in payload):
        return None, MALFORMED, "chunk sequence with a non-frame entry"
    head = payload[0]
    try:
        total = int(head["total"])
        seqs = [int(f["seq"]) for f in payload]
        schemas = {int(f["schema"]) for f in payload}
    except (KeyError, TypeError, ValueError):
        return None, MALFORMED, "chunk missing/bad seq/total/schema field"
    if len(schemas) != 1:
        return None, MALFORMED, "chunk sequence mixes schema versions"
    if total != len(payload):
        return None, MALFORMED, f"partial chunk sequence: {len(payload)} of {total} frames"
    if seqs != list(range(total)):
        return None, MALFORMED, f"chunk sequence out of order or duplicated: {seqs}"
    if any(int(f.get("total", total)) != total for f in payload):
        return None, MALFORMED, "chunk frames disagree about total"
    try:
        data = "".join(str(f["data"]) for f in payload)
    except (KeyError, TypeError):
        return None, MALFORMED, "chunk missing data field"
    merged = dict(head)
    merged["data"] = data
    merged["seq"], merged["total"] = 0, 1
    return merged, None, None


def validate_payload(payload, policy: PayloadPolicy, median: float | None = None, out=None,
                     screen: bool = True):
    """The one decode of untrusted wire bytes. Returns (table, decision,
    detail); ``table`` is a validated host float32 [r, c] ndarray only when
    decision == ACCEPTED, else None.

    ``out`` (the fast path) is a ``RingSlot`` the decoded table is written
    into once every structural check has passed; the returned table is then
    the slot's view. ``screen=False`` leaves the finite and L2 screen to the
    batched path's ``screen_block`` (same verdicts); only that path passes
    it. Each decode copy of a table counts its bytes on
    ``serve_table_bytes_copied_total``.

    Check order (the earliest failing stage reports):
      MALFORMED     structure: no payload, not a frame dict, chunk list or
                    array, a missing or bad schema field, a broken chunk
                    sequence
      STALE_SCHEMA  a wire schema this server does not speak (refused
                    before any layout field is trusted)
      MALFORMED     layout against the server's own spec: dtype, shape,
                    undecodable base64, length prefix, checksum
      QUARANTINED   a non-finite table, or one over the L2 screen

    The in-process transport passes raw ndarrays (the dtype, shape and
    quarantine screens still apply); the socket transport passes the frame
    dict its wire carried, or the list of a chunked table's frames."""
    if payload is None:
        return None, MALFORMED, "no payload on a sketch-payload round"
    if isinstance(payload, np.ndarray):
        t = payload
        if t.dtype != np.float32:
            return None, MALFORMED, f"dtype {t.dtype} != float32"
        if t.shape != (policy.rows, policy.cols):
            return None, MALFORMED, f"shape {t.shape} != ({policy.rows}, {policy.cols})"
        if out is not None:
            # in process, the client's table lands straight in its slot
            t = out.write(t)
            obreg.default().counter("serve_table_bytes_copied_total").inc(policy.nbytes)
        else:
            t = np.ascontiguousarray(t)
        return _screen_table(t, policy, median) if screen else (t, ACCEPTED, "")
    if isinstance(payload, (list, tuple)):
        payload, decision, detail = _reassemble_chunks(list(payload))
        if decision is not None:
            return None, decision, detail
    if not isinstance(payload, dict):
        return None, MALFORMED, f"payload is {type(payload).__name__}"
    try:
        schema = int(payload["schema"])
    except (KeyError, TypeError, ValueError):
        return None, MALFORMED, "missing/bad schema field"
    if schema != SCHEMA_VERSION:
        return None, STALE_SCHEMA, f"schema {schema}, server speaks {SCHEMA_VERSION}"
    try:
        if int(payload.get("total", 1)) != 1 or int(payload.get("seq", 0)):
            # a single frame claiming to be mid-sequence
            return None, MALFORMED, (f"partial chunk sequence: frame {payload.get('seq')} "
                                     f"of {payload.get('total')}")
    except (TypeError, ValueError):
        return None, MALFORMED, "bad seq/total field"
    if payload.get("dtype") != WIRE_DTYPE:
        return None, MALFORMED, f"dtype {payload.get('dtype')!r} != {WIRE_DTYPE}"
    if list(payload.get("shape", ())) != [policy.rows, policy.cols]:
        return None, MALFORMED, (f"shape {payload.get('shape')} != "
                                 f"[{policy.rows}, {policy.cols}]")
    try:
        nbytes = int(payload["nbytes"])
        crc = int(payload["crc32"])
        raw = base64.b64decode(payload["data"], validate=True)
    except (KeyError, TypeError, ValueError, binascii.Error) as e:
        return None, MALFORMED, f"undecodable frame ({type(e).__name__})"
    if nbytes != policy.nbytes:
        return None, MALFORMED, f"length prefix {nbytes} != spec {policy.nbytes}"
    if len(raw) != nbytes:
        return None, MALFORMED, f"decoded {len(raw)} bytes, length prefix says {nbytes}"
    if (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
        return None, MALFORMED, "checksum mismatch"
    wire_view = np.frombuffer(raw, dtype=WIRE_DTYPE).reshape(policy.rows, policy.cols)
    # the fast path's one copy of the table lands in its ring slot
    t = out.write(wire_view) if out is not None else wire_view.astype(np.float32)
    obreg.default().counter("serve_table_bytes_copied_total").inc(policy.nbytes)
    return _screen_table(t, policy, median) if screen else (t, ACCEPTED, "")


def _screen_table(t: np.ndarray, policy: PayloadPolicy, median: float | None = None):
    """The quarantine screen in sketch space, at the wire: a non-finite
    table always; with ``clip_multiple`` > 0, a table whose L2 norm exceeds
    that multiple of the median."""
    if not np.isfinite(t).all():
        return None, QUARANTINED, "non-finite table"
    if policy.clip_multiple > 0 and policy.quarantine_median is not None:
        med = float(policy.quarantine_median()) if median is None else float(median)
        if med > 0:
            norm = float(np.sqrt(np.square(t, dtype=np.float64).sum()))
            if norm > policy.clip_multiple * med:
                return None, QUARANTINED, (f"sketch L2 {norm:.3g} > {policy.clip_multiple:g} x "
                                           f"median {med:.3g}")
    return t, ACCEPTED, ""


def screen_block(entries, policy: PayloadPolicy):
    """The batched path's finite and L2 screen, one numpy pass over each
    ring block's span of the entries' slots instead of one reduction a
    table. ``entries``: (table, median, block, slot index) each; a table
    with no slot (block None, index -1: the ring overflowed) is screened
    alone. Returns one (decision, detail) an entry.

    The verdicts are bitwise ``_screen_table``'s: each row of a contiguous
    [m, r, c] span sums its r * c contiguous elements in the order the 2-D
    sum does (numpy's pairwise summation depends on the layout only), the
    float64 square and root are exact elementwise, and the detail formats
    the same double. Medians come resolved (the target round's snapshot);
    the live ``quarantine_median`` is never read here."""
    verdicts: list = [None] * len(entries)
    want_norms = policy.clip_multiple > 0 and policy.quarantine_median is not None
    groups: dict[int, tuple[Any, list[int]]] = {}
    for i, (t, med, blk, slot) in enumerate(entries):
        if blk is not None and slot >= 0:
            groups.setdefault(id(blk), (blk, []))[1].append(i)
        else:
            _t, decision, detail = _screen_table(t, policy, med)
            verdicts[i] = (decision, detail)
    for blk, idxs in groups.values():
        rows = [entries[i][3] for i in idxs]
        lo, hi = min(rows), max(rows)
        span = blk.tables[lo:hi + 1]
        finite = np.isfinite(span).all(axis=(1, 2))
        norms = np.sqrt(np.square(span, dtype=np.float64).sum(axis=(1, 2))) if want_norms \
            else None
        for i, row in zip(idxs, rows):
            if not finite[row - lo]:
                verdicts[i] = (QUARANTINED, "non-finite table")
                continue
            med = float(entries[i][1])
            if want_norms and med > 0:
                norm = float(norms[row - lo])
                if norm > policy.clip_multiple * med:
                    verdicts[i] = (QUARANTINED, f"sketch L2 {norm:.3g} > "
                                                f"{policy.clip_multiple:g} x median {med:.3g}")
                    continue
            verdicts[i] = (ACCEPTED, "")
    return verdicts


class _Window:
    """One round's open window: invite map (client id -> cohort position),
    arrivals, dedup set and the round's quarantine-median snapshot."""

    __slots__ = ("invited", "arrivals", "seen", "median")

    def __init__(self, invited: dict[int, int], median: float):
        self.invited = invited
        self.arrivals: list[Arrival] = []
        self.seen: set[int] = set()
        self.median = median


class IngestQueue:
    """Bounded arrival queue over up to ``MAX_OPEN_ROUNDS`` open per-round
    windows, plus a bounded pending buffer of early submissions and, with
    ``stale_rounds`` > 0, the buffered-async band: a bounded stale buffer
    (``stale_capacity``) of late payloads for rounds closed at most
    ``stale_rounds`` behind the newest window, each closed round's screen
    state (median, invite map, dedup set) kept while it is in the band.
    ``stale_rounds`` 0 (the sync service) keeps none of it. Thread-safe:
    transports submit from their own threads; the assembler consumes under
    the same lock."""

    def __init__(self, capacity: int = 1024, pending_capacity: int = 256,
                 payload_policy: PayloadPolicy | None = None, shed_watermark: float = 0.0,
                 shed_retry_after_s: float = 1.0, stale_rounds: int = 0,
                 stale_capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if stale_rounds < 0:
            raise ValueError(f"stale_rounds must be >= 0, got {stale_rounds}")
        if not 0.0 <= shed_watermark <= 1.0:
            raise ValueError(f"shed_watermark must be in [0, 1] (a fraction of total queue "
                             f"capacity; 0 = shedding off), got {shed_watermark}")
        self.capacity = capacity
        self.pending_capacity = max(pending_capacity, 0)
        # None = announce path: payloads are not decoded
        self.payload_policy = payload_policy
        # the buffered-async band; its capacity exists only with the band,
        # so a sync queue's depth and watermark are unchanged
        self.stale_rounds = stale_rounds
        self.stale_capacity = max(stale_capacity, 0) if stale_rounds else 0
        # depth at or past this share of the total capacity (one window's
        # arrivals + pending + the stale band) sheds submissions; 0 = off
        self._shed_depth = (max(int(shed_watermark * (capacity + self.pending_capacity
                                                      + self.stale_capacity)), 1)
                            if shed_watermark > 0 else 0)
        self.shed_retry_after_s = shed_retry_after_s
        self._cv = threading.Condition()
        self._windows: dict[int, _Window] = {}
        # --serve_fastpath: the open rounds' ring blocks (serve/ring.py),
        # dropped at the close; a block's lock is a leaf under this one
        self._blocks: dict[int, Any] = {}
        # the newest round ever opened; the pending buffer targets _newest + 1
        self._newest: int | None = None
        # closed rounds in the band: round -> (median, invited, seen), so a
        # late payload is screened against the state its round had
        self._recent: dict[int, tuple[float, dict[int, int], set[int]]] = {}
        self._stale: list[StaleArrival] = []
        self._closed = False
        # early submissions for round _newest + 1: (client_id, latency_s),
        # in arrival order, deduped; admitted at the window's open
        self._pending: list[tuple[int, float]] = []
        self._recv_counter = 0
        # optional accept hook (the service's arrival meter), called with
        # n=1 under the queue lock
        self.on_accept = None
        self.accepted = 0
        self.buffered = 0
        self.accepted_stale = 0
        self.rejected_full = 0
        self.rejected_dup = 0
        self.rejected_out_of_round = 0
        self.rejected_uninvited = 0
        self.rejected_closed = 0
        self.rejected_malformed = 0
        self.rejected_stale_schema = 0
        self.rejected_quarantined = 0
        self.shed = 0

    def note_wire_malformed(self) -> None:
        """Count a MALFORMED rejection the transport decided (an oversized
        frame, an unparseable line, a chunk sequence cut off by a dead
        connection), which never reaches ``submit``."""
        with self._cv:
            self.rejected_malformed += 1

    # -- round lifecycle (assembler side) -------------------------------

    def open_round(self, rnd: int, invited_ids) -> None:
        """Open round ``rnd``'s window for the cohort. Pending early
        submissions from invited clients are admitted at once (receive
        order kept); the others stay parked for the round after."""
        median = 0.0
        p = self.payload_policy
        if p is not None and p.clip_multiple > 0 and p.quarantine_median is not None:
            median = float(p.quarantine_median())
        with self._cv:
            if self._closed:
                raise RuntimeError("IngestQueue is closed")
            if rnd in self._windows:
                raise RuntimeError(f"round {rnd} is already open")
            if len(self._windows) >= MAX_OPEN_ROUNDS:
                raise RuntimeError(
                    f"open_round({rnd}): {len(self._windows)} window(s) already open "
                    f"({sorted(self._windows)}), MAX_OPEN_ROUNDS={MAX_OPEN_ROUNDS}")
            win = _Window({int(c): i for i, c in enumerate(invited_ids)}, median)
            self._windows[rnd] = win
            self._newest = rnd if self._newest is None else max(self._newest, rnd)
            # the band moves with the newest window
            if self.stale_rounds:
                low = self._newest - self.stale_rounds
                for r in [r for r in self._recent if r < low]:
                    del self._recent[r]
            else:
                self._recent.clear()
            still_pending: list[tuple[int, float]] = []
            for cid, latency in self._pending:
                if cid in win.invited and cid not in win.seen:
                    self._admit(win, cid, latency)
                else:
                    still_pending.append((cid, latency))
            self._pending = still_pending
            self._cv.notify_all()

    def attach_block(self, rnd: int, block) -> None:
        """Arm the fast path for open round ``rnd``: its decoded payloads
        land in ``block``'s slots until its close."""
        with self._cv:
            if rnd in self._windows:
                self._blocks[rnd] = block

    def _acquire_slot(self, rnd: int):
        """(block, slot) of a fast-path decode for round ``rnd``: (block,
        None) when the block is full (the decode makes a table of its own,
        counted as ring overflow), (None, None) with no block attached."""
        with self._cv:
            blk = self._blocks.get(int(rnd))
        if blk is None:
            return None, None
        return blk, blk.acquire()

    def close_round(self, rnd: int | None = None) -> list[Arrival]:
        """Close one open window (None = the oldest) and return its
        arrivals in submission order; later submissions naming it are
        OUT_OF_ROUND, or ACCEPTED_STALE inside the async band."""
        with self._cv:
            if rnd is None:
                if not self._windows:
                    return []
                rnd = min(self._windows)
            win = self._windows.pop(rnd, None)
            self._blocks.pop(rnd, None)  # no ring acquire past the close
            if win is None:
                return []
            if self.stale_rounds:
                # the round's screen state, kept for the band
                self._recent[rnd] = (win.median, win.invited, win.seen)
            return list(win.arrivals)

    def arrivals(self, rnd: int | None = None) -> list[Arrival]:
        """Snapshot of an open round's arrivals so far (None = oldest)."""
        with self._cv:
            win = self._window(rnd)
            return list(win.arrivals) if win is not None else []

    def _window(self, rnd: int | None) -> _Window | None:
        if rnd is not None:
            return self._windows.get(rnd)
        if not self._windows:
            return None
        return self._windows[min(self._windows)]

    def wait_for(self, count: int, timeout_s: float, rnd: int | None = None) -> list[Arrival]:
        """Block until round ``rnd``'s window (None = oldest open) holds >=
        ``count`` arrivals or ``timeout_s`` passes; return the snapshot
        (the wall-clock close of the socket transport)."""
        with self._cv:
            def ready():
                win = self._window(rnd)
                return self._closed or (win is not None and len(win.arrivals) >= count)

            self._cv.wait_for(ready, timeout=timeout_s)
            win = self._window(rnd)
            return list(win.arrivals) if win is not None else []

    def shutdown(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- submission (transport side) ------------------------------------

    def submit(self, sub: Submission) -> str:
        """The admission decision for one submission (rule order in the
        module docstring)."""
        status = self._decide(sub)
        self._finish_submit(sub, status)
        return status

    def _finish_submit(self, sub: Submission, status: str) -> None:
        """A submission's own counters and trace instant, whichever path
        (inline or batched) decided it."""
        reg = obreg.default()
        counter = _REJECTION_COUNTERS.get(status)
        if counter is not None:
            reg.counter(counter).inc()
        reg.counter(_ADMISSION_COUNTERS.get(status, "serve_admission_other_total")).inc()
        if obtrace.get().enabled:
            obtrace.instant("serve-ingest", f"submit:{status}",
                            submission=f"r{int(sub.round)}/c{int(sub.client_id)}",
                            round=int(sub.round), client=int(sub.client_id))

    def submit_block(self, subs) -> list[str]:
        """The batched admission (the gauntlet pool's entry): one decision a
        submission, in order, each bitwise the one ``submit`` gives and
        attributed to its submission alone. The batch changes when the
        screen's arithmetic runs, one numpy pass over the block's ring rows,
        never what it computes."""
        subs = list(subs)
        statuses = self._decide_block(subs)
        for sub, status in zip(subs, statuses):
            self._finish_submit(sub, status)
        return statuses

    def _decide_block(self, subs: list[Submission]) -> list[str]:
        n = len(subs)
        statuses: list[str | None] = [None] * n
        medians = [0.0] * n
        # the checks before the decode, for the whole block under one lock
        # hold (an announce submission is admitted here, as inline)
        with self._cv:
            announced = False
            for i, sub in enumerate(subs):
                cid = int(sub.client_id)
                status, stale_median = self._precheck(sub, cid)
                if status is not None:
                    statuses[i] = status
                    continue
                win = self._windows.get(sub.round)
                if self.payload_policy is None:
                    self._admit(win, cid, float(sub.latency_s))
                    statuses[i] = ACCEPTED
                    announced = True
                    continue
                medians[i] = win.median if win is not None else stale_median
            if announced:
                self._cv.notify_all()
        if self.payload_policy is None or all(s is not None for s in statuses):
            return statuses
        # each frame's structural checks, outside the lock; an accepted
        # table lands in its round's ring slot, its screen deferred
        entries = []  # (i, sub, blk, slot, table)
        for i, sub in enumerate(subs):
            if statuses[i] is not None:
                continue
            blk, slot = self._acquire_slot(sub.round)
            table, decision, detail = validate_payload(sub.payload, self.payload_policy,
                                                       median=medians[i], out=slot,
                                                       screen=False)
            if decision != ACCEPTED:
                statuses[i] = self._reject_decoded(sub, decision, detail, blk, slot)
                continue
            entries.append((i, sub, blk, slot, table))
        # one finite and L2 pass over the block
        verdicts = screen_block(
            [(t, medians[i], blk, slot.index if slot is not None else -1)
             for i, _sub, blk, slot, t in entries], self.payload_policy)
        # each survivor's admission checks again, as inline
        for (i, sub, blk, slot, table), (decision, detail) in zip(entries, verdicts):
            if decision != ACCEPTED:
                statuses[i] = self._reject_decoded(sub, decision, detail, blk, slot)
            else:
                statuses[i] = self._admit_decoded(sub, table, blk, slot)
        return statuses

    def _decide(self, sub: Submission) -> str:
        cid = int(sub.client_id)
        with self._cv:
            status, stale_median = self._precheck(sub, cid)
            if status is not None:
                return status
            win = self._windows.get(sub.round)
            if self.payload_policy is None:
                self._admit(win, cid, float(sub.latency_s))
                self._cv.notify_all()
                return ACCEPTED
            # a stale-band candidate is screened against its own round's
            # retained median
            median = win.median if win is not None else stale_median
        # the payload decode runs outside the lock (base64, crc32 and numpy
        # over up to a frame cap of bytes), then the admission re-checks;
        # with a ring block attached the table lands in a slot
        blk, slot = self._acquire_slot(sub.round)
        table, decision, detail = validate_payload(sub.payload, self.payload_policy,
                                                   median=median, out=slot)
        if decision != ACCEPTED:
            return self._reject_decoded(sub, decision, detail, blk, slot)
        return self._admit_decoded(sub, table, blk, slot)

    def _reject_decoded(self, sub: Submission, decision: str, detail: str, blk=None,
                        slot=None) -> str:
        """A validation's rejection (inline and batched): its counter and
        its stderr line; a ring slot the decode wrote is zeroed back."""
        if slot is not None:
            blk.reject(slot)
        with self._cv:
            if decision == MALFORMED:
                self.rejected_malformed += 1
            elif decision == STALE_SCHEMA:
                self.rejected_stale_schema += 1
            else:
                self.rejected_quarantined += 1
        print(f"serve: payload from client {int(sub.client_id)} rejected {decision} ({detail})",
              file=sys.stderr, flush=True)
        return decision

    def _admit_decoded(self, sub: Submission, table, blk=None, slot=None) -> str:
        """The admission checks after a validation (inline and batched):
        the round may have closed, a duplicate landed or the window filled
        while this thread decoded. A ring slot is committed at the client's
        cohort position or rejected back to zero; a late admission copies
        its table out of the ring first (a ring view never outlives its
        round)."""
        cid = int(sub.client_id)
        pos = -1
        with self._cv:
            if self._closed:
                self.rejected_closed += 1
                status = CLOSED
            else:
                win = self._windows.get(sub.round)
                if win is None:
                    # a late payload, or the window closed while this thread
                    # decoded: the band may take it
                    status = self._admit_stale(
                        sub, cid, np.array(table, np.float32) if slot is not None else table)
                elif cid in win.seen:
                    self.rejected_dup += 1
                    status = DUPLICATE
                elif len(win.arrivals) >= self.capacity:
                    self.rejected_full += 1
                    status = QUEUE_FULL
                else:
                    self._admit(win, cid, float(sub.latency_s), table)
                    pos = win.invited[cid]
                    self._cv.notify_all()
                    status = ACCEPTED
                    attached = self._blocks.get(sub.round)
                    if slot is None and attached is not None:
                        # a table with no slot (the ring overflowed, or it
                        # was decoded before the block was attached) lands
                        # on its own, registered before the close can read
                        attached.add_extra(pos, table)
        if slot is not None:
            if status == ACCEPTED:
                blk.commit(slot, pos)
            else:
                blk.reject(slot)
        return status

    def _precheck(self, sub: Submission, cid: int) -> tuple[str | None, float]:
        """Every check before the payload decode (lock held): (the decision,
        or None when the submission is admissible so far; the round's
        retained median when it is a stale-band candidate)."""
        if self._closed:
            self.rejected_closed += 1
            return CLOSED, 0.0
        if self._shed_depth and self.depth_locked() >= self._shed_depth:
            win = self._windows.get(sub.round)
            recent = self._recent.get(sub.round)
            if (win is not None and cid in win.seen) or (recent is not None
                                                         and cid in recent[2]):
                # at-least-once under overload: a retry of a submission
                # admitted into the window or the stale band hears DUPLICATE
                # (success), not SHEDDING
                self.rejected_dup += 1
                return DUPLICATE, 0.0
            self.shed += 1
            return SHEDDING, 0.0
        win = self._windows.get(sub.round)
        if win is None:
            if (self._newest is not None and sub.round == self._newest + 1
                    and self.payload_policy is None):
                # an early push for the round after the newest window:
                # parked, bounded (a retry of a parked push is DUPLICATE
                # even when the buffer is full)
                if any(c == cid for c, _ in self._pending):
                    self.rejected_dup += 1
                    return DUPLICATE, 0.0
                if len(self._pending) >= self.pending_capacity:
                    self.rejected_full += 1
                    return QUEUE_FULL, 0.0
                self._pending.append((cid, float(sub.latency_s)))
                self.buffered += 1
                return BUFFERED, 0.0
            # late: the async band takes a payload for a recently closed
            # round, checked against that round's state
            recent = self._recent.get(sub.round) if self.payload_policy is not None else None
            if recent is not None:
                _, invited, seen = recent
                if cid not in invited:
                    self.rejected_uninvited += 1
                    return NOT_INVITED, 0.0
                if cid in seen:
                    self.rejected_dup += 1
                    return DUPLICATE, 0.0
                if len(self._stale) >= self.stale_capacity:
                    self.rejected_full += 1
                    return QUEUE_FULL, 0.0
                return None, recent[0]
            self.rejected_out_of_round += 1
            return OUT_OF_ROUND, 0.0
        if cid not in win.invited:
            self.rejected_uninvited += 1
            return NOT_INVITED, 0.0
        if cid in win.seen:
            self.rejected_dup += 1
            return DUPLICATE, 0.0
        if len(win.arrivals) >= self.capacity:
            self.rejected_full += 1
            return QUEUE_FULL, 0.0
        return None, 0.0

    def _admit_stale(self, sub: Submission, cid: int, table) -> str:
        """Admit a validated late payload into the stale buffer (lock held),
        after the checks ``_precheck`` ran again: the band may have moved
        while this thread decoded."""
        recent = self._recent.get(sub.round)
        if recent is None:
            self.rejected_out_of_round += 1
            return OUT_OF_ROUND
        _, invited, seen = recent
        if cid not in invited:
            self.rejected_uninvited += 1
            return NOT_INVITED
        if cid in seen:
            self.rejected_dup += 1
            return DUPLICATE
        if len(self._stale) >= self.stale_capacity:
            self.rejected_full += 1
            return QUEUE_FULL
        seen.add(cid)
        self._stale.append(StaleArrival(int(sub.round), cid, float(sub.latency_s),
                                        self._recv_counter, time.perf_counter(), table))
        self._recv_counter += 1
        self.accepted_stale += 1
        self._cv.notify_all()
        return ACCEPTED_STALE

    def _admit(self, win: _Window, cid: int, latency_s: float, table=None) -> None:
        """Record an accepted arrival into a window (lock held)."""
        win.arrivals.append(Arrival(cid, latency_s, self._recv_counter, time.perf_counter(),
                                    table))
        self._recv_counter += 1
        win.seen.add(cid)
        self.accepted += 1
        if self.on_accept is not None:
            self.on_accept(1)

    def drain_stale(self) -> list[StaleArrival]:
        """Hand the parked late payloads to the service (which folds them
        into a merge) and clear the buffer."""
        with self._cv:
            out, self._stale = self._stale, []
            return out

    def prune_stale(self, rnd: int) -> int:
        """Drop parked late payloads and kept band state of rounds >= ``rnd``
        and rewind the newest-window mark below ``rnd``: the rewind's queue
        half, so a round that never committed is served again with no
        pre-rewind twin of its late payloads, and the replay's BUFFERED and
        OUT_OF_ROUND verdicts are the original run's. Returns how many
        parked payloads it dropped."""
        with self._cv:
            before = len(self._stale)
            self._stale = [a for a in self._stale if a.round < rnd]
            for r in [r for r in self._recent if r >= rnd]:
                del self._recent[r]
            if self._newest is not None and self._newest >= rnd:
                self._newest = rnd - 1 if rnd > 0 else None
            return before - len(self._stale)

    # -- introspection --------------------------------------------------

    def depth_locked(self) -> int:
        return (sum(len(w.arrivals) for w in self._windows.values()) + len(self._pending)
                + len(self._stale))

    def depth(self) -> int:
        """Arrivals across every open window plus parked early and late
        submissions (the queue depth ``/metrics`` reports)."""
        with self._cv:
            return self.depth_locked()

    def open_rounds(self) -> list[int]:
        """The rounds with an open window, oldest first."""
        with self._cv:
            return sorted(self._windows)

    def pending_snapshot(self) -> list[tuple[int, float]]:
        """Checkpointable view of the early-submission buffer."""
        with self._cv:
            return list(self._pending)

    def restore_pending(self, pending) -> None:
        """Re-seed the early-submission buffer from a checkpoint."""
        with self._cv:
            self._pending = [(int(c), float(s)) for c, s in pending]

    def band_snapshot(self) -> dict:
        """The async band's state, which a resumed or rewound run needs for
        its folds to replay bitwise: the parked late payloads (tables
        included), the kept screen state of closed rounds, the newest-window
        mark and the admission counter. Tables stay ndarrays; the service
        encodes them for a checkpoint."""
        with self._cv:
            return self._band_snapshot_locked()

    def _band_snapshot_locked(self) -> dict:
        return {
            "stale": [(a.round, a.client_id, a.latency_s, a.recv_order, a.wall_t, a.table)
                      for a in self._stale],
            "recent": [(r, m, dict(inv), set(seen)) for r, (m, inv, seen) in self._recent.items()],
            "newest": self._newest,
            "recv_counter": self._recv_counter,
        }

    def boundary_snapshot(self) -> tuple[list, dict]:
        """(pending, band) under one lock hold: a round boundary's
        checkpoint pair, which a submission between two separate reads
        could tear."""
        with self._cv:
            return list(self._pending), self._band_snapshot_locked()

    def restore_band(self, band: dict) -> None:
        """Re-seed the async band from a snapshot (the committed boundary's,
        on a rewind or a resume)."""
        with self._cv:
            self._stale = [StaleArrival(int(r), int(c), float(lat), int(ro), float(w), t)
                           for r, c, lat, ro, w, t in band.get("stale", [])]
            self._recent = {int(r): (float(m), {int(c): int(p) for c, p in inv.items()},
                                     {int(c) for c in seen})
                            for r, m, inv, seen in band.get("recent", [])}
            self._newest = None if band.get("newest") is None else int(band["newest"])
            self._recv_counter = int(band.get("recv_counter", self._recv_counter))

    def counters(self) -> dict[str, int]:
        with self._cv:
            return {
                "accepted": self.accepted,
                "buffered": self.buffered,
                "accepted_stale": self.accepted_stale,
                "rejected_full": self.rejected_full,
                "rejected_dup": self.rejected_dup,
                "rejected_out_of_round": self.rejected_out_of_round,
                "rejected_uninvited": self.rejected_uninvited,
                "rejected_closed": self.rejected_closed,
                "rejected_malformed": self.rejected_malformed,
                "rejected_stale_schema": self.rejected_stale_schema,
                "rejected_quarantined": self.rejected_quarantined,
                "shed": self.shed,
            }
