"""Sharded ingest over worker processes, the root's half (``--serve_shards
N --serve_shard_mode process``; the port's copy of the JAX package's
``serve/scale/procshard.py``). The worker's half is
``procshard_worker.py``.

Thread shards (``shard.py``) spread connections over N reactors, but every
decode, screen and admission still runs under the root's one interpreter
lock. Process shards move that work into N worker processes, shared
nothing:

- the root reserves the shared port (a bound SO_REUSEPORT socket that
  never listens: it holds the address without joining the kernel's accept
  group), then starts N workers (``spawn.start_child``: numpy and the
  standard library only, never torch); each binds and listens with
  SO_REUSEPORT on that port, and the kernel spreads connections among them;
- a client is owned by its ``shard_for`` worker, which holds its admission
  state outright (dedup, early buffer, the screen against the round's
  median, which the root broadcasts at each open); the kernel's misroutes
  are counted and forwarded to the owner's direct port;
- with the fast path the hand-off is one ``ShmRingBlock`` a shard
  (``shmring.py``), sized by the cohort, created and unlinked by the root
  alone; the root's close reads the blocks the workers wrote. Without it
  the validated tables cross the control connection, pickled. Workers move
  bytes and verdicts, never arithmetic, so the served run is bitwise the
  one-listener run either way;
- a worker's life is part of the service: SIGTERM drains it; ``shard_kill``
  (``resilience/faults.py``) SIGKILLs it mid-run, and its clients are
  dropped and requeued (they never arrive: exactly a client_drop of the
  same set); a death is counted (``serve_shard_deaths_total``), a dead
  worker is started again at the next round's open, and the workers'
  counters are folded into the root's registry, so ``/metrics`` and
  ``/metrics.prom`` read one registry as ever.

``ProcShardedIngest`` is the transport the service drives (start/stop,
``address``, ``addr_for``, ``submit``, ``counters``); ``ProcShardQueue``
is the ``IngestQueue`` surface the service and the assembler drive
(``open_round``, ``close_round``, ``wait_for``, ``depth``, ``counters``,
the boundary bookkeeping) over the control connections. The compositions
that assume the one queue in the root (``--serve_pipeline``,
``--serve_async``, ``--serve_edges``) are refused at the service's
construction.

Before a block is zeroed again (by its worker when "open" arrives, or by
the root when the worker is dead), the root waits for the device copy of
the block's previous round (``upload_done``, set by the service's
uploader): the worker cannot wait on the root's CUDA event, so the root
sends "open" only after that wait.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from ...obs import registry as obreg
from ..ingest import Arrival
from ..transport import DEFAULT_MAX_FRAME_BYTES, submit_over_socket
from .eventloop import DEFAULT_MAX_CONNS_EVENTLOOP
from .shard import shard_counters, shard_for
from .shmring import ShmRingBlock, layout, shm_free_bytes
from .spawn import start_child

WORKER_TARGET = "commefficient_tpu_torch.serve.scale.procshard_worker:worker_main"


class _WorkerHandle:
    """The root's view of one worker: its process, its control connection
    (one request and its reply at a time, under ``lock``), and the last
    counters it shipped (a dead worker's last counts stay counted)."""

    def __init__(self, shard_id: int):
        self.shard_id = shard_id
        self.proc = None
        self.ctl = None
        self.lock = threading.Lock()
        self.direct_addr: tuple[str, int] | None = None
        self.alive = False
        self.last_queue_counters: dict = {}
        self.last_registry: dict = {}
        # this incarnation's counter values already folded into the root's
        # registry
        self._pushed: dict[str, float] = {}
        self.spawn_s = 0.0  # seconds from start to the ready handshake
        # the device runtimes the worker reported holding (refused unless
        # empty)
        self.imported: list = []


class ProcShardedIngest:
    """N SO_REUSEPORT worker processes over shared-nothing shard queues
    (module docstring)."""

    def __init__(self, n_shards: int, payload_shape=None, payload_policy=None,
                 host: str = "127.0.0.1", port: int = 0, fastpath: bool = False,
                 gauntlet_workers: int = 2, queue_kwargs: dict | None = None,
                 read_deadline_s: float = 30.0, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 max_conns: int = DEFAULT_MAX_CONNS_EVENTLOOP, ready_timeout_s: float = 30.0):
        if n_shards < 2:
            raise ValueError(f"n_shards must be >= 2, got {n_shards} (one shard IS the plain "
                             "event-loop transport - use EventLoopTransport)")
        self.n_shards = int(n_shards)
        self.payload_shape = payload_shape
        self.payload_policy = payload_policy
        self.fastpath = bool(fastpath) and payload_shape is not None
        self.gauntlet_workers = int(gauntlet_workers)
        self.queue_kwargs = dict(queue_kwargs or {})
        self.read_deadline_s = read_deadline_s
        self.max_frame_bytes = max_frame_bytes
        self.max_conns = max_conns
        self.ready_timeout_s = ready_timeout_s
        self._host, self._port = host, int(port)
        self._reserve: socket.socket | None = None  # holds the shared port
        self.workers = [_WorkerHandle(k) for k in range(self.n_shards)]
        self.queue = ProcShardQueue(self)
        self._blocks: list[ShmRingBlock] | None = None
        self._block_cap = 0
        self._started = False
        self._stop_lock = threading.Lock()
        # (shard, seconds) of every start after the first of a worker
        self.respawns: list[tuple[int, float]] = []
        # a hook the service sets: called with each root-side block when it
        # is made (the device copies' view of its tables)
        self.on_block = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((self._host, self._port))
        # no listen(): the root holds the port without joining the accept
        # group, so only the workers' sockets receive connections
        self._reserve = s
        self._port = s.getsockname()[1]
        try:
            self._spawn(self.workers)
            self._broadcast_peers()
        except BaseException:
            self.stop()
            raise
        self._started = True

    def _worker_cfg(self, shard_id: int) -> dict:
        rows, cols = self.payload_shape if self.payload_shape is not None else (0, 0)
        clip = (float(self.payload_policy.clip_multiple) if self.payload_policy is not None
                else 0.0)
        return {"shard_id": shard_id, "n_shards": self.n_shards, "host": self._host,
                "port": self._port, "rows": rows, "cols": cols, "clip_multiple": clip,
                "fastpath": self.fastpath, "gauntlet_workers": self.gauntlet_workers,
                "read_deadline_s": self.read_deadline_s,
                "max_frame_bytes": self.max_frame_bytes, "max_conns": self.max_conns,
                **{k: self.queue_kwargs[k] for k in (
                    "queue_capacity", "pending_capacity", "shed_watermark",
                    "shed_retry_after_s") if k in self.queue_kwargs}}

    def _spawn(self, handles: list) -> None:
        """Start the workers ``handles`` together, then wait for each one's
        ready handshake; raises if one never reports ready, or reports a
        device runtime imported (every one started is killed then)."""
        t0 = time.perf_counter()
        started = [(w, *start_child(WORKER_TARGET, (self._worker_cfg(w.shard_id),)))
                   for w in handles]
        try:
            for w, proc, ctl in started:
                try:
                    if not ctl.poll(max(self.ready_timeout_s - (time.perf_counter() - t0), 0.0)):
                        raise RuntimeError(f"shard worker {w.shard_id} never reported ready "
                                           f"within {self.ready_timeout_s:g} s (pid {proc.pid})")
                    msg = ctl.recv()
                except (EOFError, OSError) as e:
                    raise RuntimeError(f"shard worker {w.shard_id} died before its ready "
                                       f"handshake (pid {proc.pid}): {e!r}") from None
                if msg[0] != "ready":
                    raise RuntimeError(f"shard worker {w.shard_id} bad handshake: {msg!r}")
                if msg[3]:
                    raise RuntimeError(f"shard worker {w.shard_id} imported {msg[3]}: a worker "
                                       "process must hold numpy and the standard library only")
                w.proc, w.ctl = proc, ctl
                w.imported = list(msg[3])
                w.direct_addr = tuple(msg[2])
                w.alive = True
                w._pushed = {}
                w.spawn_s = time.perf_counter() - t0
        except BaseException:
            for w, proc, ctl in started:
                w.alive = False
                w.proc = w.ctl = None
                proc.kill()
                proc.wait()
                ctl.close()
            raise

    def _broadcast_peers(self) -> None:
        self._all(("peers", {w.shard_id: w.direct_addr for w in self.workers if w.alive}))

    def respawn_dead(self) -> None:
        """Start the dead workers again (at each round's open): a fresh
        process with an empty shard queue, like a restarted shard of a
        deployment, and the peers told its new direct port."""
        dead = [w for w in self.workers if not w.alive]
        if not dead:
            return
        for w in dead:
            self._close_handle(w)
        try:
            self._spawn(dead)
        except (OSError, RuntimeError) as e:
            print(f"serve: shard respawn failed: {e}", file=sys.stderr, flush=True)
            return
        for w in dead:
            self.respawns.append((w.shard_id, w.spawn_s))
            print(f"serve: shard {w.shard_id} worker respawned (pid {w.proc.pid}, "
                  f"{w.spawn_s:.2f} s)", file=sys.stderr, flush=True)
        self._broadcast_peers()

    def _close_handle(self, w: _WorkerHandle) -> None:
        if w.proc is not None:
            if w.proc.poll() is None:
                w.proc.kill()
            w.proc.wait()
        if w.ctl is not None:
            try:
                w.ctl.close()
            except OSError:
                pass
            w.ctl = None

    def stop(self, join_deadline_s: float = 5.0) -> None:
        """Drain every worker (a last counter snapshot, then SIGTERM), kill
        what outlives the deadline, unlink the segments and free the port."""
        with self._stop_lock:
            for k, reply in self._all(("stop",), timeout_s=join_deadline_s).items():
                if reply and reply[0] == "stopped":
                    self.workers[k].last_queue_counters = reply[1]
                    self._push_registry(self.workers[k], reply[2])
            for w in self.workers:
                if w.proc is not None and w.proc.poll() is None:
                    try:
                        w.proc.terminate()  # SIGTERM: the drain
                    except OSError:
                        pass
            deadline = time.monotonic() + join_deadline_s
            for w in self.workers:
                if w.proc is not None:
                    try:
                        w.proc.wait(max(deadline - time.monotonic(), 0.1))
                    except subprocess.TimeoutExpired:
                        pass  # killed just below
                    w.alive = False
                    self._close_handle(w)
            self._release_blocks()
            if self._reserve is not None:
                try:
                    self._reserve.close()
                except OSError:
                    pass
                self._reserve = None
            self._started = False

    def _release_blocks(self) -> None:
        """Unlink every segment: the one cleanup path (the root's; workers
        only close their mappings), run by ``stop`` on every exit of the
        service."""
        if self._blocks is not None:
            for b in self._blocks:
                b.close()
                b.unlink()
            self._blocks = None
            self._block_cap = 0

    # -- the control connections ----------------------------------------

    def _fanout(self, msgs: dict, timeout_s: float = 15.0) -> dict:
        """Send each live worker named in ``msgs`` (shard -> request) its
        request, then collect the replies: the round trip of the slowest
        worker, not the sum of them. Returns {shard: reply}; a worker whose
        connection breaks or stays silent is marked dead (counted) and left
        out. Each worker's lock is held from its send to its reply, so two
        threads' requests never interleave on one connection."""
        live = [w for w in self.workers if w.shard_id in msgs and w.alive and w.ctl is not None]
        for w in live:  # in shard order: no two callers deadlock
            w.lock.acquire()
        try:
            sent = []
            for w in live:
                try:
                    w.ctl.send(msgs[w.shard_id])
                    sent.append(w)
                except OSError:
                    self._mark_dead(w, why=f"its connection broke on {msgs[w.shard_id][0]!r}")
            out = {}
            deadline = time.monotonic() + timeout_s
            for w in sent:
                op = msgs[w.shard_id][0]
                try:
                    if not w.ctl.poll(max(deadline - time.monotonic(), 0.0)):
                        self._mark_dead(w, why=f"no reply to {op!r} within {timeout_s:g} s")
                        continue
                    out[w.shard_id] = w.ctl.recv()
                except (EOFError, OSError):
                    self._mark_dead(w, why=f"its connection broke on {op!r}")
            return out
        finally:
            for w in live:
                w.lock.release()

    def _all(self, msg: tuple, timeout_s: float = 15.0) -> dict:
        """``msg`` to every live worker at once: {shard: reply}."""
        return self._fanout({w.shard_id: msg for w in self.workers}, timeout_s)

    def _mark_dead(self, w: _WorkerHandle, why: str) -> None:
        if not w.alive:
            return
        w.alive = False
        obreg.default().counter("serve_shard_deaths_total").inc()
        print(f"serve: shard {w.shard_id} worker DEAD ({why}): its clients are dropped and "
              "requeued this round; it starts again at the next open", file=sys.stderr,
              flush=True)

    def kill_shard(self, shard_id: int) -> None:
        """The shard_kill fault: SIGKILL the worker mid-run, no drain (an
        out-of-memory kill or a crash). Its clients' submissions fail at the
        socket and the round closes without them."""
        w = self.workers[int(shard_id)]
        if not w.alive or w.proc is None:
            return
        try:
            os.kill(w.proc.pid, signal.SIGKILL)
            w.proc.wait(5.0)
        except (OSError, ValueError):
            pass
        self._mark_dead(w, why="shard_kill fault")

    # -- the transport surface ------------------------------------------

    @property
    def address(self) -> tuple[str, int] | None:
        return (self._host, self._port) if self._started else None

    @property
    def addresses(self) -> list:
        return [w.direct_addr for w in self.workers]

    def addr_for(self, client_id: int) -> tuple[str, int] | None:
        return self.workers[shard_for(client_id, self.n_shards)].direct_addr

    def submit(self, sub) -> str:
        """Client-side round trip to the client's owner."""
        addr = self.addr_for(sub.client_id)
        if addr is None:
            raise RuntimeError("ProcShardedIngest not started")
        return submit_over_socket(addr, sub)

    # -- counters across the process boundary ---------------------------

    def _push_registry(self, w: _WorkerHandle, snap: dict) -> None:
        """Fold a worker's registry snapshot into the root's: each counter as
        its growth since this incarnation's last fold, the worker's own
        per-shard gauges as set."""
        reg = obreg.default()
        w.last_registry = snap
        for name, val in snap.items():
            if isinstance(val, (int, float)):  # a counter
                delta = float(val) - w._pushed.get(name, 0.0)
                if delta > 0:
                    reg.counter(name).inc(delta)
                    w._pushed[name] = float(val)
            elif (isinstance(val, dict) and "value" in val
                  and name.startswith(f"serve_shard{w.shard_id}_")):
                reg.gauge(name).set(float(val["value"]))

    def poll_counters(self) -> None:
        """Fetch and fold every live worker's counters."""
        for k, (qc, snap) in self._all(("counters",), timeout_s=5.0).items():
            self.workers[k].last_queue_counters = qc
            self._push_registry(self.workers[k], snap)

    def counters(self) -> dict:
        """The per-shard block of ``/metrics``: the thread shards' fields,
        plus each worker's liveness and pid."""
        self.poll_counters()
        out = {}
        for w in self.workers:
            snap = w.last_registry

            def value(name, snap=snap):
                v = snap.get(name, 0)
                return v["value"] if isinstance(v, dict) else v

            row = shard_counters([w.shard_id], [w.direct_addr], value)[str(w.shard_id)]
            out[str(w.shard_id)] = {**row, "alive": bool(w.alive),
                                    "pid": w.proc.pid if w.proc is not None else None}
        return out

    # -- the shared-memory ring -----------------------------------------

    def prepare_blocks(self, capacity: int) -> list[ShmRingBlock]:
        """One root-side block a shard, each of ``capacity`` slots (the whole
        cohort: one shape every round and every shard; ownership keeps each
        about 1/N full). Made once, again only if the cohort's size changes.
        Raises, naming the bytes, when ``/dev/shm`` cannot hold them all."""
        if self._blocks is not None and self._block_cap != int(capacity):
            self._release_blocks()
        if self._blocks is None:
            rows, cols = self.payload_shape
            need = self.n_shards * layout(rows, cols, int(capacity))[4]
            free = shm_free_bytes()
            if free is not None and need > free:
                raise RuntimeError(f"serve: {self.n_shards} shared-memory table ring blocks of "
                                   f"{capacity} x {rows} x {cols} need {need} bytes; "
                                   f"/dev/shm has {free} bytes free")
            blocks = []
            try:
                for _ in range(self.n_shards):
                    blocks.append(ShmRingBlock.create(rows, cols, int(capacity)))
                    if self.on_block is not None:
                        self.on_block(blocks[-1])
            except BaseException:
                for b in blocks:
                    b.close()
                    b.unlink()
                raise
            self._blocks, self._block_cap = blocks, int(capacity)
        return self._blocks

    def ring_blocks(self) -> list[ShmRingBlock]:
        if self._blocks is None:
            raise RuntimeError("no fast-path round is open on the process shards")
        return self._blocks

    @property
    def shm_bytes(self) -> int:
        """Bytes of the segments the root holds now."""
        return sum(b.nbytes for b in self._blocks) if self._blocks is not None else 0


class ProcShardQueue:
    """The ``IngestQueue`` surface the service and the assembler drive,
    over the workers' control connections. The admission state lives in
    the workers; this object routes the round's life and sums the counters.
    The early buffer's checkpoint and the async band do not cross the
    process boundary (the service refuses async; a restored early buffer
    is reported and dropped)."""

    def __init__(self, transport: ProcShardedIngest):
        self.t = transport
        self.payload_policy = transport.payload_policy
        self.shed_retry_after_s = float(transport.queue_kwargs.get("shed_retry_after_s", 1.0))
        self.on_accept = None
        self._open: dict[int, np.ndarray] = {}
        self._closed = False
        self._counters_lock = threading.Lock()

    # -- the round's life ------------------------------------------------

    def open_round(self, rnd: int, invited_ids) -> None:
        if self._closed:
            raise RuntimeError("ProcShardQueue is closed")
        if rnd in self._open:
            raise RuntimeError(f"round {rnd} is already open")
        self.t.respawn_dead()
        ids = np.asarray(invited_ids, np.int64)
        # the round's screen median, computed once in the root (it may read
        # device state) and sent to every shard, as the one queue reads it
        median = 0.0
        p = self.payload_policy
        if p is not None and p.clip_multiple > 0 and p.quarantine_median is not None:
            median = float(p.quarantine_median())
        blocks, cap = [None] * self.t.n_shards, 0
        if self.t.fastpath:
            blocks, cap = self.t.prepare_blocks(len(ids)), len(ids)
            for b in blocks:
                # no worker may rewrite bytes a device copy still reads, and
                # a worker cannot wait on the root's CUDA event: "open" (at
                # which a live worker resets its block) goes after this
                b.rearm(rnd)
        opened = self.t._fanout({k: ("open", int(rnd), ids, median,
                                     b.name if b is not None else None, cap)
                                 for k, b in enumerate(blocks)})
        for k, b in enumerate(blocks):
            if b is not None and k not in opened:
                # a dead shard's block: its last round's slots must not land
                # in this one
                b.reset(rnd)
        self._open[rnd] = ids

    def close_round(self, rnd: int | None = None) -> list[Arrival]:
        """Close the round in every live worker and merge their arrivals:
        receive order ``order * n + shard`` (each shard's own order kept,
        residues disjoint), sorted by (latency, client id), a function of
        the submissions alone, never of the processes' timing."""
        if rnd is None:
            if not self._open:
                return []
            rnd = min(self._open)
        if self._open.pop(rnd, None) is None:
            return []
        merged: list[Arrival] = []
        n = self.t.n_shards
        # a dead shard's clients never arrived
        for k, (_, meta, extras) in self.t._all(("close", int(rnd))).items():
            merged.extend(Arrival(client_id=cid, latency_s=lat, recv_order=order * n + k,
                                  wall_t=wall, table=table)
                          for cid, lat, order, wall, table in meta)
            if extras and self.t._blocks is not None:
                self.t._blocks[k].adopt_extras(extras)
        merged.sort(key=lambda a: (a.latency_s, a.client_id))
        if self.on_accept is not None:
            for _ in merged:
                self.on_accept(1)
        return merged

    def _gather_meta(self, rnd: int) -> list[Arrival]:
        n = self.t.n_shards
        return [Arrival(client_id=cid, latency_s=lat, recv_order=order * n + k, wall_t=wall)
                for k, meta in self.t._all(("arrivals", int(rnd)), timeout_s=5.0).items()
                for cid, lat, order, wall, _ in meta]

    def wait_for(self, count: int, timeout_s: float, rnd: int | None = None) -> list[Arrival]:
        """The wall-clock close's wait: poll the workers' counts until
        ``count`` arrived or ``timeout_s`` passed."""
        deadline = time.monotonic() + timeout_s
        if rnd is None and self._open:
            rnd = min(self._open)
        while True:
            total = sum(self.t._all(("count", int(rnd)), timeout_s=5.0).values())
            if self._closed or total >= count or time.monotonic() >= deadline:
                return self._gather_meta(rnd)
            time.sleep(0.005)

    def shutdown(self) -> None:
        self._closed = True

    # -- the metrics and bookkeeping surfaces ---------------------------

    def depth(self) -> int:
        return sum(self.t._all(("depth",), timeout_s=5.0).values())

    def counters(self) -> dict[str, int]:
        """The admission totals over every shard (a dead shard's last
        snapshot included)."""
        with self._counters_lock:
            self.t.poll_counters()
            out: dict[str, int] = {}
            for w in self.t.workers:
                for k, v in w.last_queue_counters.items():
                    out[k] = out.get(k, 0) + int(v)
            return out

    def open_rounds(self) -> list[int]:
        return sorted(self._open)

    def prune_stale(self, rnd: int) -> int:
        return 0  # no stale band (async is refused)

    def boundary_snapshot(self):
        return [], {}

    def restore_pending(self, pending) -> None:
        if pending:
            print(f"serve: NOTE - {len(pending)} checkpointed pending early submission(s) NOT "
                  "restored: the process shards' early buffers live in the workers",
                  file=sys.stderr, flush=True)
