"""The streaming aggregation service: the batch round inverted, clients
pushing submissions at an aggregator (the port of the JAX package's
``serve/``, synchronous serial serving).

- ``ingest``    — the bounded arrival queue with admission control
  (backpressure, duplicates, out-of-round, early-push buffering, load
  shedding) and the payload validation (``validate_payload``);
- ``transport`` — in-process and loopback-socket (threaded) submission
  fronts and the client helpers; ``scale/eventloop`` — the selectors
  reactor, the default socket engine;
- ``assembler`` — cohorts that close at W-of-N arrivals; payload rounds
  collect the validated table stack;
- ``clients``   — per-client streams and device classes as pure functions
  of (seed, client id[, round]);
- ``traffic``   — the trace-driven traffic generator, with the payload
  round's wire faults applied at the transport seam;
- ``metrics``   — the ``/metrics`` endpoint;
- ``service``   — ``AggregationService`` and ``ServedSource``, the round
  source ``runner.run_loop(source=...)`` takes.

Both CLIs take ``--serve inproc|socket`` with ``--serve_payload
announce|sketch``, ``--serve_quorum``, ``--serve_deadline``,
``--serve_trace``, ``--serve_shed_watermark``, ``--serve_metrics_port``,
``--serve_port``, ``--serve_max_conns`` and ``--serve_transport
eventloop|threaded``.
"""

from .assembler import ClosedRound, CohortAssembler
from .ingest import IngestQueue, PayloadPolicy, Submission, validate_payload
from .metrics import MetricsServer
from .service import AggregationService, ServeConfig, ServedSource, service_from_args
from .traffic import TraceConfig, TrafficGenerator
from .transport import (InProcessTransport, SocketTransport, abort_over_socket,
                        submit_over_socket, submit_with_retries)

__all__ = [
    "AggregationService",
    "ClosedRound",
    "CohortAssembler",
    "InProcessTransport",
    "IngestQueue",
    "MetricsServer",
    "PayloadPolicy",
    "ServeConfig",
    "ServedSource",
    "SocketTransport",
    "Submission",
    "TraceConfig",
    "TrafficGenerator",
    "abort_over_socket",
    "service_from_args",
    "submit_over_socket",
    "submit_with_retries",
    "validate_payload",
]
