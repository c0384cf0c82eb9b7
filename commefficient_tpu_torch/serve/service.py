"""The aggregation service: a running server over the session (the port's
copy of the JAX package's ``serve/service.py``, the synchronous serial
service).

``AggregationService`` owns the serving stack (ingest queue, transport,
cohort assembler, traffic, metrics endpoint) and gives the run loop a
``ServedSource``: the round source ``runner.run_loop(source=...)`` pulls
from instead of the sampling prefetcher. A served round, on the dispatch
thread:

    1. ``session.sample_cohort(rnd)``    the invite list (the batch round's
                                         host draws: the parity rests on it)
    2. ``queue.open_round(rnd, ids)``    parked early submissions of invited
                                         clients admit at once
    3. traffic pushes submissions        transport.submit -> admission
    4. the assembler closes at W-of-N    quorum or deadline
    5. ``session.prepare_served_round``  the casualties are masked and
                                         queued exactly as client_drop faults

With ``--serve_payload sketch`` the round becomes the wire-payload round
(``_serve_payload_round``): the clients compute their [r, c] tables first
(``session.compute_client_tables``: one ``sketch_accumulate`` launch per
invitee on the card, then one copy of the [W, r, c] stack to the host),
the tables cross the transport (framed and checksummed over the loopback
socket when that is the transport) through the ingest validation, and the
merge (``dispatch_round``) consumes only the validated stack the close
collected. A rejected frame is bitwise a dropped client.

Threads: the socket engines and the metrics server run on threads of
their own and touch host numpy only. The client step, the copies of the
table stack and the merge dispatch run on the dispatch thread inside
``ServedSource.next()`` and ``dispatch_round``, in round order: round r's
client step reads the state round r-1's merge produced.

Checkpoints: the early-submission buffer is snapshotted at every round
boundary and published through ``session.serve_meta`` (meta.json
"serve"); a restored session's ``restored_serve_meta`` re-seeds it, so a
resumed run replays the arrival stream of the uninterrupted one.

Not ported (ROADMAP Queue 1 item 9b): the pipelined and buffered-async
services, the zero-copy fast path, sharded ingest and the edge tree.
``ServeConfig`` has no field for them, and the CLIs refuse their flags by
name (``utils/config.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time

import numpy as np

from ..obs import registry as obreg
from ..obs import trace as obtrace
from .assembler import ClosedRound, CohortAssembler
from .ingest import IngestQueue, PayloadPolicy
from .metrics import MetricsServer
from .traffic import TraceConfig, TrafficGenerator
from .transport import InProcessTransport, SocketTransport, abort_over_socket, submit_over_socket


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service shape (the --serve_* flags)."""

    quorum: int = 0            # W-of-N close; 0 = the full cohort
    deadline_s: float = 4.0    # virtual deadline of the round close
    transport: str = "inproc"  # "inproc" | "socket"
    port: int = 0              # socket bind port (0 = ephemeral)
    metrics_port: int = -1     # >= 0 starts the HTTP endpoint (0 = ephemeral)
    queue_capacity: int = 1024
    pending_capacity: int = 256
    # "announce": submissions announce arrival and the session computes
    # every update; "sketch": submissions carry the client's table through
    # the validation, and the server merges the accepted tables (needs a
    # wire_payloads=True session)
    payload: str = "announce"
    # queue depth at or past this share of capacity sheds (0 = off)
    shed_watermark: float = 0.0
    shed_retry_after_s: float = 1.0
    # the socket engine: "eventloop" (the selectors reactor, default) or
    # "threaded" (a thread per connection)
    socket_transport: str = "eventloop"
    # connection cap of the socket engine; 0 = the engine's default
    # (threaded 128, eventloop 8192)
    max_conns: int = 0

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        return cls(
            quorum=args.serve_quorum, deadline_s=args.serve_deadline, transport=args.serve,
            port=args.serve_port, metrics_port=args.serve_metrics_port,
            payload=args.serve_payload, shed_watermark=args.serve_shed_watermark,
            socket_transport=args.serve_transport, max_conns=args.serve_max_conns)


class AggregationService:
    """See the module docstring. ``session`` is a FederatedSession;
    ``traffic`` a TrafficGenerator, or None for external clients only
    (socket transport)."""

    def __init__(self, session, cfg: ServeConfig, traffic: TrafficGenerator | None = None):
        if cfg.transport not in ("inproc", "socket"):
            raise ValueError(f"serve transport must be inproc|socket, got {cfg.transport!r}")
        if cfg.payload not in ("announce", "sketch"):
            raise ValueError(f"--serve_payload must be announce|sketch, got {cfg.payload!r}")
        if cfg.socket_transport not in ("threaded", "eventloop"):
            raise ValueError(f"--serve_transport must be threaded|eventloop, got "
                             f"{cfg.socket_transport!r}")
        quorum = cfg.quorum or session.num_workers
        if not 1 <= quorum <= session.num_workers:
            raise ValueError(f"--serve_quorum {cfg.quorum} must be in [1, num_workers="
                             f"{session.num_workers}]: the quorum closes an over-provisioned "
                             "cohort, it cannot exceed the invite list")
        if traffic is None and cfg.transport == "inproc":
            raise ValueError("inproc transport with no traffic generator would serve zero "
                             "submissions (pass a TrafficGenerator, or use the socket "
                             "transport with external clients)")
        payload_policy = payload_shape = None
        if cfg.payload == "sketch":
            if not session.cfg.wire_payloads:
                raise ValueError("--serve_payload sketch needs a session built with "
                                 "wire_payloads=True (the CLIs arm it from the flag): the "
                                 "payload round is another step pair, client tables + merge")
            mcfg = session.cfg.mode
            payload_shape = (mcfg.num_rows, mcfg.num_cols)
            # the gauntlet's sketch-space screen reads the ring the merge
            # screens against, so a QUARANTINED payload is the client the
            # merge would have quarantined
            payload_policy = PayloadPolicy(
                rows=payload_shape[0], cols=payload_shape[1],
                clip_multiple=float(session.cfg.client_update_clip),
                quarantine_median=session.quarantine_median_host)
        self.session = session
        self.cfg = dataclasses.replace(cfg, quorum=quorum)
        self.traffic = traffic
        self.queue = IngestQueue(capacity=cfg.queue_capacity,
                                 pending_capacity=cfg.pending_capacity,
                                 payload_policy=payload_policy,
                                 shed_watermark=cfg.shed_watermark,
                                 shed_retry_after_s=cfg.shed_retry_after_s)
        self.assembler = CohortAssembler(self.queue, quorum, cfg.deadline_s,
                                         payload_shape=payload_shape)
        if cfg.transport == "socket":
            cap = {"max_conns": cfg.max_conns} if cfg.max_conns else {}
            if cfg.socket_transport == "eventloop":
                from .scale.eventloop import EventLoopTransport

                self.transport = EventLoopTransport(self.queue, port=cfg.port, **cap)
            else:
                self.transport = SocketTransport(self.queue, port=cfg.port, **cap)
        else:
            self.transport = InProcessTransport(self.queue)
        self.registry = obreg.default()
        self._rate = self.registry.meter("serve_arrival_rate")
        self._latency = self.registry.histogram("serve_submit_to_merge_ms")
        # a service counts only its own merges in the process-wide registry
        self._latency_base = self._latency.count
        self.queue.on_accept = self._rate.record
        # closed rounds whose merge has not committed yet: their
        # submission-to-merge latencies resolve at the commit
        self._unmerged: list[ClosedRound] = []
        self.metrics_server = (MetricsServer(self.metrics_snapshot, port=cfg.metrics_port)
                               if cfg.metrics_port >= 0 else None)
        # _pending_by_round[r]: the early-submission buffer a run positioned
        # at committed round r starts from (checkpoints write the committed
        # one)
        self._meta_lock = threading.Lock()
        self._pending_by_round: dict[int, list] = {}
        restored = session.restored_serve_meta
        if restored:
            self.queue.restore_pending(restored.get("pending", []))
            print(f"serve: restored {len(restored.get('pending', []))} pending early "
                  "submission(s) from checkpoint meta", file=sys.stderr, flush=True)
        self._pending_by_round[session.round] = self.queue.pending_snapshot()
        # the checkpoint hook: utils/checkpoint.save calls it under the
        # session's mutate_lock and writes the result into meta.json
        session.serve_meta = self._serve_meta
        self._started = False

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "AggregationService":
        if not self._started:
            self.transport.start()
            if self.metrics_server is not None:
                self.metrics_server.start()
            self._started = True
        return self

    def close(self) -> None:
        self.queue.shutdown()
        self.transport.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self._started = False

    # -- the round source -----------------------------------------------

    def source(self, start_round: int | None = None) -> "ServedSource":
        """The run loop's round source."""
        return ServedSource(self, self.session.round if start_round is None else start_round)

    @contextlib.contextmanager
    def _stage(self, name: str, rnd: int):
        """One serving stage: a span on the serve-pipeline track and the
        ``serve_stage_<name>_ms`` histogram ``/metrics`` reads."""
        t0 = time.perf_counter()
        with obtrace.span("serve-pipeline", f"stage:{name}", round=rnd):
            yield
        self.registry.histogram(f"serve_stage_{name}_ms").observe(
            (time.perf_counter() - t0) * 1e3)

    def serve_round(self, rnd: int):
        """One served round's preparation: invite, collect, close at W-of-N,
        mask and queue the casualties. Returns (PreparedRound,
        ClosedRound)."""
        with obtrace.span("assembler", "serve_round", round=rnd):
            if self.cfg.payload == "sketch":
                prep, closed = self._serve_payload_round(rnd)
            else:
                with self._stage("invite", rnd):
                    ids = self.session.sample_cohort(rnd)
                    self.queue.open_round(rnd, ids)
                with self._stage("collect", rnd):
                    if self.traffic is not None:
                        self.traffic.respond_to_invites(rnd, ids, self.transport.submit,
                                                        self.cfg.deadline_s)
                        closed = self.assembler.close_virtual(rnd, ids)
                    else:
                        closed = self.assembler.close_wall(rnd, ids)
                with self._stage("prep", rnd):
                    prep = self.session.prepare_served_round(rnd, ids, closed.arrived)
        with self._meta_lock:
            self._unmerged.append(closed)
        return prep, closed

    def _submit_fns(self):
        """(submit, abort) of the payload round's clients. Over the socket
        every submission round-trips the real wire, and a conn_drop is a
        real mid-send connection death; a transport failure raises."""
        if self.cfg.transport != "socket":
            return self.transport.submit, None
        addr = self.transport.address
        if addr is None:
            raise ConnectionError("serve: the socket transport is not listening")
        return (lambda sub: submit_over_socket(addr, sub),
                lambda sub: abort_over_socket(addr, sub))

    def _serve_payload_round(self, rnd: int):
        """The wire-payload round: the clients compute before the close (a
        real client sketches locally, then ships), the tables cross the
        transport, the validation checks each, and the close hands the merge
        only the validated stack. Every invitee whose payload missed the
        merge is masked and queued as a dropped client."""
        with self._stage("prep", rnd):
            ids = self.session.sample_cohort(rnd)
            prep0 = self.session.prepare_served_round(rnd, ids, np.ones(len(ids), np.float32))
        with self._stage("compute", rnd):
            tables, aux = self.session.compute_client_tables(prep0)
        with self._stage("invite", rnd):
            self.queue.open_round(rnd, ids)
        with self._stage("collect", rnd):
            if self.traffic is not None:
                plan = self.session.fault_plan
                wire = plan.wire_plan(rnd, len(ids)) if plan is not None else None
                submit, abort = self._submit_fns()
                self.traffic.respond_to_invites(rnd, ids, submit, self.cfg.deadline_s,
                                                payloads=tables, wire=wire, abort=abort)
                closed = self.assembler.close_virtual(rnd, ids)
            else:
                closed = self.assembler.close_wall(rnd, ids)
        with self._stage("prep", rnd):
            prep = self.session.finish_served_payload(prep0, closed.arrived, closed.tables, aux)
        return prep, closed

    def record_merges(self, committed_round: int | None = None) -> int:
        """Resolve the submission-to-merge latency of every closed round the
        session has committed: each accepted submission's accept-to-commit
        wall time goes into the ``serve_submit_to_merge_ms`` histogram.
        Returns how many resolved."""
        committed = self.session.round if committed_round is None else committed_round
        with self._meta_lock:
            ready = [c for c in self._unmerged if c.rnd < committed]
            self._unmerged = [c for c in self._unmerged if c.rnd >= committed]
        now = time.perf_counter()
        n = 0
        for closed in ready:
            for pos in range(len(closed.invited)):
                wall = float(closed.wall_ts[pos])
                if closed.arrived[pos] == 0.0 or wall == float("inf"):
                    continue  # masked out of the merge, or never accepted
                self._latency.observe((now - wall) * 1e3)
                n += 1
        return n

    # -- checkpoint and metrics surfaces --------------------------------

    def _record_boundary(self, next_round: int) -> None:
        """Snapshot the pending buffer as the state a run positioned at
        ``next_round`` starts from; drop snapshots behind the committed
        round."""
        pending = self.queue.pending_snapshot()
        with self._meta_lock:
            self._pending_by_round[next_round] = pending
            committed = self.session.round
            for r in [r for r in self._pending_by_round if r < committed]:
                del self._pending_by_round[r]

    def _serve_meta(self) -> dict:
        """The checkpoint block: the pending buffer as of the committed round
        (the caller holds the session's mutate_lock)."""
        with self._meta_lock:
            committed = self.session.round
            pending = self._pending_by_round.get(committed)
            if pending is None:
                pending = self.queue.pending_snapshot()
            return {"round": committed, "pending": [[int(c), float(s)] for c, s in pending]}

    def rewind_to_committed(self) -> None:
        """Restore the live pending buffer to the committed boundary (the
        twin of run_loop's host-RNG rewind), close any window left open and
        drop served rounds that never committed, so a session and service
        reused after an interrupted loop replay identically."""
        committed = self.session.round
        for r in self.queue.open_rounds():
            if r >= committed:
                self.queue.close_round(r)
        with self._meta_lock:
            pending = self._pending_by_round.get(committed)
            self._unmerged = [c for c in self._unmerged if c.rnd < committed]
        if pending is not None:
            self.queue.restore_pending(pending)

    def metrics_snapshot(self) -> dict:
        """The ``/metrics`` payload (``serve/metrics.py``)."""
        s = self.session
        return {
            "round": int(s.round),
            "queue_depth": self.queue.depth(),
            "arrival_rate_per_s": round(self._rate.rate(), 3),
            "submissions": self.queue.counters(),
            "rounds": self.assembler.counters(),
            "requeue_depth": len(s._requeue),
            "clients_quarantined": int(s.clients_quarantined_total),
            "latency_ms": {**self._latency.summary(),
                           "count": self._latency.count - self._latency_base},
            "round_phase_ms": {ph: self.registry.histogram(f"runner_phase_{ph}_ms").summary()
                               for ph in obreg.RUNNER_PHASES},
            "serve_stage_ms": {st: self.registry.histogram(f"serve_stage_{st}_ms").summary()
                               for st in obreg.SERVE_STAGES},
            "quorum": self.cfg.quorum,
            "invited_per_round": s.num_workers,
            "deadline_s": self.cfg.deadline_s,
            "transport": self.cfg.transport,
            "transport_engine": (self.cfg.socket_transport if self.cfg.transport == "socket"
                                 else None),
            "payload": self.cfg.payload,
            # the armed Byzantine defence: the merge (the sum or a robust
            # statistic) and how wide the quarantine screens
            "merge_policy": s.cfg.merge_policy,
            "merge_trim": int(s.cfg.merge_trim),
            "quarantine_scope": s.cfg.quarantine_scope,
        }


class ServedSource:
    """The run loop's round source backed by the service: ``next()`` runs
    the whole invite -> collect -> close cycle on the dispatch thread (the
    device still overlaps: the merge of round N runs while round N+1 is
    served, up to the payload round's table copy). ``closed_rounds`` keeps
    each round's ClosedRound for observers."""

    def __init__(self, service: AggregationService, start_round: int):
        self.service = service
        self._next = start_round
        self.last_closed: ClosedRound | None = None
        self.closed_rounds: list[ClosedRound] = []
        service._record_boundary(start_round)

    def next(self):
        rnd = self._next
        prep, closed = self.service.serve_round(rnd)
        self.service._record_boundary(rnd + 1)
        self.last_closed = closed
        self.closed_rounds.append(closed)
        self._next = rnd + 1
        return prep

    def on_committed(self, committed_round: int):
        """The run loop's commit hook: submission-to-merge latencies resolve
        at the commit that published their round."""
        self.service.record_merges(committed_round)

    def stop(self):
        # the loop may have served rounds that never commit (preemption, an
        # early exit): rewind the pending buffer with the host RNG
        self.service.rewind_to_committed()


def service_from_args(args, session) -> AggregationService | None:
    """Build and start the service of a CLI run (after the checkpoint
    restore, so a resumed service picks up the persisted pending queue);
    None with --serve off. The trace's population defaults to the
    dataset's client count and its seed to --seed unless the spec pins
    them."""
    if args.serve == "off":
        return None
    spec = args.serve_trace
    trace = TraceConfig.parse(spec)
    pinned = {p.partition("=")[0].strip() for p in spec.split(",") if p.strip()}
    if "population" not in pinned:
        trace = dataclasses.replace(trace, population=args.num_clients)
    if "seed" not in pinned:
        trace = dataclasses.replace(trace, seed=args.seed)
    scfg = ServeConfig.from_args(args)
    service = AggregationService(session, scfg, traffic=TrafficGenerator(trace)).start()
    addr = service.transport.address
    maddr = service.metrics_server.address if service.metrics_server is not None else None
    print(f"serve: {service.cfg.transport} transport"
          + (f" ({service.cfg.socket_transport})" if service.cfg.transport == "socket" else "")
          + (f" on {addr[0]}:{addr[1]}" if addr else "")
          + f", payload {service.cfg.payload}, quorum {service.cfg.quorum}/"
          + f"{session.num_workers}, deadline {service.cfg.deadline_s}s, trace {trace}"
          + (f", metrics http://{maddr[0]}:{maddr[1]}/metrics" if maddr else ""), flush=True)
    return service
