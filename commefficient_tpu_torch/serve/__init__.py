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
  fronts and the client helpers; ``scale/eventloop`` — the selectors
  reactor, the default socket engine;
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
``--serve_fastpath`` with ``--serve_gauntlet_workers``.
"""

from .assembler import ClosedRound, CohortAssembler
from .gauntlet import GauntletPool
from .ingest import IngestQueue, PayloadPolicy, Submission, screen_block, validate_payload
from .metrics import FASTPATH_METRICS, MetricsServer, register_fastpath
from .pipeline import RoundPipeline
from .ring import RingBlock, RingSlot, TableRing
from .service import (AggregationService, ServeConfig, ServedSource, ServeFollower,
                      service_from_args)
from .traffic import TraceConfig, TrafficGenerator
from .transport import (InProcessTransport, SocketTransport, abort_over_socket,
                        submit_over_socket, submit_with_retries)

__all__ = [
    "AggregationService",
    "ClosedRound",
    "CohortAssembler",
    "FASTPATH_METRICS",
    "GauntletPool",
    "InProcessTransport",
    "IngestQueue",
    "MetricsServer",
    "PayloadPolicy",
    "RingBlock",
    "RingSlot",
    "RoundPipeline",
    "ServeConfig",
    "ServeFollower",
    "ServedSource",
    "SocketTransport",
    "Submission",
    "TableRing",
    "TraceConfig",
    "TrafficGenerator",
    "abort_over_socket",
    "register_fastpath",
    "screen_block",
    "service_from_args",
    "submit_over_socket",
    "submit_with_retries",
    "validate_payload",
]
