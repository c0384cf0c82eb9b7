"""The port's run loop: the PyTorch twin of the JAX package's ``runner/``.

- ``prefetch.RoundPrefetcher``: background preparation of round batches
  via ``FederatedSession.prepare_round``, in round order, keeping the
  RNG-snapshot and retry semantics (a retried or replayed load is
  bitwise the same).
- ``writer.AsyncCheckpointWriter``: periodic checkpoint writes on a thread
  of their own; emergency, preemption and final saves stay synchronous.
- ``loop.run_loop``: the loop: dispatches without a host sync, metrics
  read at eval, checkpoint, in-flight-depth and end boundaries in one copy
  per drain, the watchdog, preemption and the non-finite halt; with
  ``source=`` a served run's rounds come from the aggregation service.

``--sync_loop`` is the serial path; the async loop is pinned bitwise equal
to it by tests/test_torch_runner.py.
"""

from .loop import RunnerConfig, RunStats, auto_inflight, make_save_ckpt, measure_rtt_ms, run_loop
from .prefetch import PreparedSource, RoundPrefetcher
from .writer import AsyncCheckpointWriter

__all__ = [
    "AsyncCheckpointWriter",
    "PreparedSource",
    "RoundPrefetcher",
    "RunStats",
    "RunnerConfig",
    "auto_inflight",
    "make_save_ckpt",
    "measure_rtt_ms",
    "run_loop",
]
