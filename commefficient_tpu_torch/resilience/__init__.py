"""Fault injection and failure recovery for the port's run loop: the
PyTorch twin of the JAX package's ``resilience/`` for one process.

- ``faults``: a seeded ``FaultPlan`` injecting failures at named sites and
  scheduled rounds (preemption, data-loader stalls and failures, eval
  stalls, NaN/Inf bursts, checkpoint write failures and damage, and the
  cohort faults: dropped, straggling and poisoned clients, and the wire
  faults of the payload round: corrupt, truncated, duplicated, delayed and
  dropped frames).
- ``retry``: bounded retries with exponential backoff and seeded jitter
  around checkpoint IO and data loading.
- ``preemption``: a SIGTERM handler that lets the loop finish its in-flight
  rounds, take an emergency checkpoint and exit with a resumable status.

The recovery these prove out lives where the failures happen: verified
checkpoints in ``utils.checkpoint``, the non-finite round guard in
``federated.engine`` and the ``RoundWatchdog`` ladder in ``utils.watchdog``.
"""

from .faults import FaultPlan, FaultSpec, InjectedFault, InjectedTransientError
from .preemption import EXIT_RESUMABLE, PreemptionHandler
from .retry import RetryPolicy, reset_retry_counts, retry_counts, with_retries

__all__ = [
    "EXIT_RESUMABLE",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "InjectedTransientError",
    "PreemptionHandler",
    "RetryPolicy",
    "reset_retry_counts",
    "retry_counts",
    "with_retries",
]
