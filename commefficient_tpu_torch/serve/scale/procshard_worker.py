"""A shard worker process of ``--serve_shard_mode process`` (the port's copy
of the JAX package's ``serve/scale/procshard_worker.py``; ``procshard.py``
is the root's half).

A worker owns one shard's ingest: its own pair of event-loop reactors, its
own batched validation (with ``--serve_fastpath``), and its own
``IngestQueue`` holding its ``shard_for`` slice of the admission state
(dedup set, early-submission buffer, the quarantine screen against the
round's median, which the root broadcasts at each open). It talks to the
root over two channels only: the control connection (round opens and
closes, counter snapshots, the stop) and, with the fast path, the
shared-memory ring block its validated tables land in (``shmring.py``).
Decode, screen arithmetic and admission bookkeeping never run in the root.

Sockets:

- the main reactor binds with SO_REUSEPORT on the service's shared port,
  and the kernel spreads connections over the workers by their 4-tuple
  hash, blind to client ids; a frame for a client this worker does not own
  is a misroute: counted, forwarded to the owner's direct port over
  loopback (``_Forwarder``, a thread of its own), and the owner's verdict
  relayed on the original connection, deferred through the reactor's wake
  pipe, so the reactor never waits on a forward;
- the direct reactor listens on a private ephemeral port, reported to the
  root in the ready handshake and shared with the peers: hash-routed
  traffic (``addr_for``) and peer forwards land there, and it never
  forwards (it is the owner, so forwards cannot loop).

Lifecycle: SIGTERM drains (stop accepting, answer what is in flight,
detach from the segment, exit 0); a SIGKILL mid-round is the ``shard_kill``
fault: the root sees the dead connection, counts the death, and the
shard's clients are dropped and requeued (they never arrive, exactly a
client_drop of the same set).

Numpy and the standard library only, at every level of its imports: the
ready handshake reports the heavy modules the process holds (``torch`` or
``jax``), and the root refuses a worker that holds any.
"""

from __future__ import annotations

import signal
import sys
import threading

import numpy as np

from ...obs import registry as obreg
from ..ingest import IngestQueue, PayloadPolicy
from ..transport import submit_over_socket
from .eventloop import EventLoopTransport
from .shard import shard_for
from .shmring import ShmRingBlock

# modules a worker must never hold: a device runtime in N processes
HEAVY_MODULES = ("torch", "jax")


class _Forwarder:
    """The misroute relay: one thread round-trips a forwarded submission to
    its owner's direct port and hands the verdict to the reactor's deferred
    reply. The blocking is here, never on the reactor."""

    def __init__(self, shard_id: int):
        self.shard_id = shard_id
        self.peers: dict[int, tuple[str, int]] = {}
        self._q: list = []
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._run, name=f"shard{shard_id}-forward",
                                        daemon=True)
        self._thread.start()

    def set_peers(self, peers: dict) -> None:
        with self._cv:
            self.peers = {int(k): tuple(v) for k, v in peers.items()}

    def enqueue(self, owner: int, sub, deliver) -> None:
        with self._cv:
            self._q.append((owner, sub, deliver))
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._q or self._stop)
                if self._stop and not self._q:
                    return
                owner, sub, deliver = self._q.pop(0)
                addr = self.peers.get(owner)
            status = "CONN_FAILED"
            if addr is not None:
                try:
                    status = submit_over_socket(addr, sub)
                except (OSError, ValueError):
                    # the owner is unreachable (dead, draining): the client
                    # hears a transport failure and retries as it would
                    pass
            deliver(status)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=2.0)


class _WorkerReactor(EventLoopTransport):
    """The reactor on the shared SO_REUSEPORT port: it decides the
    submissions of the clients this worker owns and forwards the rest to
    their owner, relaying the verdict through the deferred reply (the
    batched validation's mechanism)."""

    def __init__(self, queue: IngestQueue, shard_id: int, n_shards: int,
                 forwarder: _Forwarder, **kw):
        super().__init__(queue, shard_id=shard_id, reuse_port=True, **kw)
        self.n_shards = n_shards
        self.forwarder = forwarder

    def _submit_reply(self, sub):
        owner = shard_for(sub.client_id, self.n_shards)
        if owner == self.shard_id:
            return super()._submit_reply(sub)
        self._shard_counter("misrouted").inc()
        conn = self._cur_conn

        def deliver(status: str) -> None:
            with self._deferred_lock:
                self._deferred.append((conn, status))
            self._wake()

        self.forwarder.enqueue(owner, sub, deliver)
        return None  # the reply comes with the owner's verdict


def _arrival_meta(arrivals, ship_tables: bool) -> list:
    """The arrivals as plain tuples for the control connection: (client id,
    latency, receive order, wall time, table). With the ring the tables are
    already in the segment and none is shipped; without it each validated
    table crosses pickled."""
    return [(int(a.client_id), float(a.latency_s), int(a.recv_order), float(a.wall_t),
             np.asarray(a.table, np.float32) if ship_tables and a.table is not None else None)
            for a in arrivals]


def worker_main(cfg: dict, ctl) -> None:
    """The child's entry (``spawn.start_child``). ``cfg`` is the root's plain
    dict (``procshard.ProcShardedIngest._worker_cfg``), ``ctl`` the control
    connection. Every request is a tuple and gets exactly one reply; the
    root sends one request at a time."""
    shard_id, n_shards = int(cfg["shard_id"]), int(cfg["n_shards"])
    drain = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: drain.set())
    median = [0.0]  # the round's quarantine median, as the root broadcast it
    policy = None
    if cfg.get("rows"):
        policy = PayloadPolicy(rows=int(cfg["rows"]), cols=int(cfg["cols"]),
                               clip_multiple=float(cfg.get("clip_multiple", 0.0)),
                               quarantine_median=lambda: median[0])
    queue = IngestQueue(capacity=int(cfg.get("queue_capacity", 1024)),
                        pending_capacity=int(cfg.get("pending_capacity", 256)),
                        payload_policy=policy,
                        shed_watermark=float(cfg.get("shed_watermark", 0.0)),
                        shed_retry_after_s=float(cfg.get("shed_retry_after_s", 1.0)))
    gauntlet = None
    if cfg.get("fastpath"):
        from ..gauntlet import GauntletPool

        gauntlet = GauntletPool(queue, workers=int(cfg.get("gauntlet_workers", 2))).start()
    forwarder = _Forwarder(shard_id)
    kw = dict(host=cfg["host"], max_conns=int(cfg["max_conns"]),
              max_frame_bytes=int(cfg["max_frame_bytes"]),
              read_deadline_s=float(cfg["read_deadline_s"]))
    main = _WorkerReactor(queue, shard_id=shard_id, n_shards=n_shards, forwarder=forwarder,
                          port=int(cfg["port"]), **kw)
    direct = EventLoopTransport(queue, shard_id=shard_id, port=0, **kw)
    main.gauntlet = direct.gauntlet = gauntlet
    blocks: dict[str, ShmRingBlock] = {}
    armed: dict[int, ShmRingBlock] = {}
    try:
        main.start()
        direct.start()
        ctl.send(("ready", shard_id, direct.address,
                  [m for m in HEAVY_MODULES if m in sys.modules]))
        while not drain.is_set():
            if not ctl.poll(0.2):
                continue
            try:
                msg = ctl.recv()
            except (EOFError, OSError):
                break  # the root is gone: drain
            op = msg[0]
            if op == "peers":
                forwarder.set_peers(msg[1])
                ctl.send(("ok",))
            elif op == "open":
                _, rnd, ids, med, shm_name, cap = msg
                median[0] = float(med)
                block = None
                if shm_name is not None:
                    block = blocks.get(shm_name)
                    if block is None:
                        block = blocks[shm_name] = ShmRingBlock.attach(
                            shm_name, int(cfg["rows"]), int(cfg["cols"]), int(cap))
                    block.reset(int(rnd))
                queue.open_round(int(rnd), np.asarray(ids, np.int64))
                if block is not None:
                    queue.attach_block(int(rnd), block)
                    armed[int(rnd)] = block
                ctl.send(("ok",))
            elif op == "close":
                rnd = int(msg[1])
                arrivals = queue.close_round(rnd)
                block = armed.pop(rnd, None)
                extras = []
                if block is not None:
                    # every acquired slot is final before the reply: the
                    # root's reads of the segment come after this round trip
                    block.wait_final(5.0)
                    extras = [(int(p), np.asarray(t, np.float32)) for p, t in block.extras]
                ctl.send(("closed", _arrival_meta(arrivals, ship_tables=block is None), extras))
            elif op == "count":
                ctl.send(len(queue.arrivals(int(msg[1]))))
            elif op == "arrivals":
                ctl.send(_arrival_meta(queue.arrivals(int(msg[1])), ship_tables=False))
            elif op == "depth":
                ctl.send(queue.depth())
            elif op == "counters":
                ctl.send((queue.counters(), obreg.default().snapshot()))
            elif op == "stop":
                ctl.send(("stopped", queue.counters(), obreg.default().snapshot()))
                break
            else:
                ctl.send(("error", f"unknown op {op!r}"))
    finally:
        # the drain (SIGTERM, "stop", or the root's end of the connection
        # closed): stop accepting, fail what is in flight, detach from the
        # segments (the root alone unlinks them)
        main.stop()
        direct.stop()
        if gauntlet is not None:
            gauntlet.stop()
        forwarder.stop()
        queue.shutdown()
        for b in blocks.values():
            b.close()
        try:
            ctl.close()
        except OSError:
            pass
    sys.exit(0)
