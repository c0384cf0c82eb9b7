"""Sharded ingest over reactor threads (``--serve_shards N
--serve_shard_mode thread``; the port's copy of the JAX package's
``serve/scale/shard.py``): N event-loop reactors, each with its own
listener and thread, in front of the one thread-safe ``IngestQueue``.

The admission state (windows, dedup, capacity, the shed watermark) stays
one source of truth while connection handling and decode spread over the
reactors. Clients are routed by client-id hash: ``shard_for(client_id,
n)`` (splitmix64 under a fixed seed, so the assignment is uniform and
stable across runs and resumes) names the shard a client connects to, and
``addr_for`` gives its address. A submission that lands on the wrong shard
is still decided right (the queue is shared), but that shard counts it as
misrouted (``serve_shard<k>_misrouted_total``). The per-shard series are
the reactors' (``eventloop.py``); ``counters`` gathers them for the
``/metrics`` JSON ``shards`` block.

Numpy and the standard library only: ``shard_for`` is on a shard worker
process's import chain (``procshard_worker.py``).
"""

from __future__ import annotations

import numpy as np

from ...obs import registry as obreg
from ..clients import fold_in_host
from ..ingest import IngestQueue
from ..transport import DEFAULT_MAX_FRAME_BYTES, submit_over_socket
from .eventloop import _FD_HEADROOM, DEFAULT_MAX_CONNS_EVENTLOOP, EventLoopTransport, raise_nofile

# the routing stream's fixed seed: which shard owns a client is a property of
# the deployment, not of a run's --seed, so a resume (or a new seed) does not
# reshuffle it
_ROUTE_SEED = 0x5CA1E


def shard_for(client_id, n_shards: int):
    """The shard a client id hashes to: one splitmix64 fold of the bare id
    (``serve/clients.py``'s ``fold_in_host``) modulo ``n_shards``; an int
    for a scalar id, an int64 array for an array of ids."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    out = fold_in_host(_ROUTE_SEED, np.asarray(client_id)) % np.uint64(n_shards)
    return out.astype(np.int64) if out.ndim else int(out)


def shard_counters(shard_ids, addresses, value) -> dict:
    """The ``/metrics`` ``shards`` block, one entry a shard, from
    ``value(name)``: a registry series' value by name."""
    out = {}
    for k, addr in zip(shard_ids, addresses):
        out[str(k)] = {
            "addr": f"{addr[0]}:{addr[1]}" if addr else None,
            "conns": int(value(f"serve_shard{k}_conns")),
            "submissions": int(value(f"serve_shard{k}_submissions_total")),
            "shed": int(value(f"serve_shard{k}_shed_total")),
            "misrouted": int(value(f"serve_shard{k}_misrouted_total")),
            "conn_refused": int(value(f"serve_shard{k}_conn_refused_total")),
            "retry_after_s": float(value(f"serve_shard{k}_retry_after_s")),
        }
    return out


class ShardedIngest:
    """N event-loop reactors over one IngestQueue (module docstring), with
    the transport surface the service drives: start/stop, ``submit``,
    ``address`` (shard 0's), ``addresses`` and ``addr_for``."""

    def __init__(self, queue: IngestQueue, n_shards: int, host: str = "127.0.0.1",
                 port: int = 0, read_deadline_s: float = 30.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 max_conns: int = DEFAULT_MAX_CONNS_EVENTLOOP):
        if n_shards < 2:
            raise ValueError(f"n_shards must be >= 2, got {n_shards} (one shard IS the plain "
                             "event-loop transport - use EventLoopTransport)")
        self.queue = queue
        self.n_shards = n_shards
        self.max_conns = max_conns
        # a base port pins shard k to port + k; 0 lets the OS pick each
        self.shards = [
            _ShardReactor(queue, shard_id=k, n_shards=n_shards, host=host,
                          port=port + k if port else 0, read_deadline_s=read_deadline_s,
                          max_frame_bytes=max_frame_bytes, max_conns=max_conns)
            for k in range(n_shards)]

    def start(self) -> None:
        raise_nofile(self.n_shards * self.max_conns + _FD_HEADROOM)
        for s in self.shards:
            s.start()

    def stop(self, join_deadline_s: float = 5.0) -> None:
        for s in self.shards:
            s.stop(join_deadline_s=join_deadline_s)

    @property
    def address(self) -> tuple[str, int] | None:
        return self.shards[0].address

    @property
    def addresses(self) -> list:
        return [s.address for s in self.shards]

    def addr_for(self, client_id: int) -> tuple[str, int] | None:
        return self.shards[shard_for(client_id, self.n_shards)].address

    def submit(self, sub) -> str:
        """Client-side round trip to the client's shard."""
        addr = self.addr_for(sub.client_id)
        if addr is None:
            raise RuntimeError("ShardedIngest not started")
        return submit_over_socket(addr, sub)

    def counters(self) -> dict:
        """The per-shard block of ``/metrics``."""
        snap = obreg.default().snapshot()

        def value(name):
            v = snap.get(name, 0)
            return v["value"] if isinstance(v, dict) else v

        return shard_counters(range(self.n_shards), self.addresses, value)


class _ShardReactor(EventLoopTransport):
    """One shard's reactor: the event-loop transport, counting a submission
    whose client hashes to another shard as misrouted (and deciding it
    like any other: the queue is shared)."""

    def __init__(self, queue: IngestQueue, shard_id: int, n_shards: int, **kw):
        super().__init__(queue, shard_id=shard_id, **kw)
        self.n_shards = n_shards

    def _submit_reply(self, sub):
        if shard_for(sub.client_id, self.n_shards) != self.shard_id:
            self._shard_counter("misrouted").inc()
        return super()._submit_reply(sub)
