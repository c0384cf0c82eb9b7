"""The streaming aggregation service: the batch round inverted, clients
pushing submissions at an aggregator (the port of the JAX package's
``serve/``: the sync and the buffered-async service, serial or pipelined,
on one device or a group of ranks).

- ``ingest``    — the bounded arrival queue with admission control
  (backpressure, duplicates, out-of-round, early-push buffering, load
  shedding, the async band's late admissions) and the payload validation
  (``validate_payload``; batched, ``submit_block`` and ``screen_block``);
- ``ring``      — ``TableRing``, the pooled (on the GPU pinned) host blocks
  a ``--serve_fastpath`` round's tables land in once;
- ``gauntlet``  — ``GauntletPool``, the fast path's batched validation
  over the socket;
- ``transport`` — in-process and loopback-socket (threaded) submission
  fronts and the client helpers; ``scale/`` — the selectors reactor (the
  default socket engine), the sharded ingest over reactor threads or
  SO_REUSEPORT worker processes with their shared-memory table ring, the
  load generator, and the two-tier edge tree (``scale/edge.py``);
- ``assembler`` — cohorts that close at W-of-N arrivals (or the async
  buffer size); payload rounds collect the validated table stack, and
  async ones the stragglers' tables;
- ``clients``   — per-client streams and device classes as pure functions
  of (seed, client id[, round]);
- ``traffic``   — the trace-driven traffic generator, with the payload
  round's wire faults applied at the transport seam;
- ``metrics``   — the ``/metrics`` endpoint;
- ``service``   — ``AggregationService`` and ``ServedSource``, the round
  source ``runner.run_loop(source=...)`` takes; ``ServeFollower``, a
  served group's part on the ranks other than 0;
- ``pipeline``  — ``RoundPipeline``, the serve cycle run one round ahead
  on a worker thread (``--serve_pipeline``).

Both CLIs take ``--serve inproc|socket`` with ``--serve_payload
announce|sketch``, ``--serve_quorum``, ``--serve_deadline``,
``--serve_trace``, ``--serve_shed_watermark``, ``--serve_metrics_port``,
``--serve_port``, ``--serve_max_conns``, ``--serve_transport
eventloop|threaded``, ``--serve_pipeline``, ``--serve_async`` with
``--serve_buffer``, ``--serve_staleness`` and ``--serve_stale_rounds``, and
``--serve_fastpath`` with ``--serve_gauntlet_workers``,
``--serve_shards`` with ``--serve_shard_mode thread|process``, and
``--serve_edges``.

The names below resolve on first access (PEP 562): a shard worker process
imports ``serve.ingest``, ``serve.transport`` and ``serve.scale`` through
this package, and must not import torch (``service``, ``ring`` and
``pipeline`` do).
"""

_EXPORTS = {
    "ClosedRound": "assembler",
    "CohortAssembler": "assembler",
    "GauntletPool": "gauntlet",
    "IngestQueue": "ingest",
    "PayloadPolicy": "ingest",
    "Submission": "ingest",
    "screen_block": "ingest",
    "validate_payload": "ingest",
    "FASTPATH_METRICS": "metrics",
    "MetricsServer": "metrics",
    "register_fastpath": "metrics",
    "RoundPipeline": "pipeline",
    "EdgeTree": "scale.edge",
    "assign_edges": "scale.edge",
    "RingBlock": "ring",
    "RingSlot": "slots",
    "TableRing": "ring",
    "AggregationService": "service",
    "ServeConfig": "service",
    "ServedSource": "service",
    "ServeFollower": "service",
    "service_from_args": "service",
    "TraceConfig": "traffic",
    "TrafficGenerator": "traffic",
    "InProcessTransport": "transport",
    "SocketTransport": "transport",
    "abort_over_socket": "transport",
    "submit_over_socket": "transport",
    "submit_with_retries": "transport",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
