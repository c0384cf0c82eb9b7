"""Bounded retries with exponential backoff and seeded jitter: the port's
copy of the JAX package's ``resilience/retry.py``.

One wrapper for every host operation that can flake (checkpoint IO, data
loading). The jitter is seeded so a retried run replays the same delays,
and exhaustion re-raises the last error unchanged. Failed attempts are
counted per site in a plain module dictionary (``retry_counts``).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable

import numpy as np

_COUNTS_LOCK = threading.Lock()
_RETRY_COUNTS: dict[str, int] = {}


def _count_failure(site: str) -> None:
    with _COUNTS_LOCK:
        _RETRY_COUNTS[site] = _RETRY_COUNTS.get(site, 0) + 1


def retry_counts() -> dict[str, int]:
    """{site: failed-attempt count} since process start or the last reset.
    A site absent from the dict never failed."""
    with _COUNTS_LOCK:
        return dict(_RETRY_COUNTS)


def reset_retry_counts() -> None:
    with _COUNTS_LOCK:
        _RETRY_COUNTS.clear()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """max_retries: extra attempts after the first. The delay before retry i
    is base_delay_s * backoff**i, capped at max_delay_s, plus a uniform
    jitter of up to ``jitter`` of that delay."""

    max_retries: int = 3
    base_delay_s: float = 0.1
    backoff: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.25
    retry_on: tuple = (Exception,)

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")

    def delay_s(self, attempt: int, rng: np.random.RandomState) -> float:
        base = min(self.base_delay_s * self.backoff**attempt, self.max_delay_s)
        return base * (1.0 + self.jitter * float(rng.uniform()))


def with_retries(fn: Callable, *, site: str, policy: RetryPolicy | None = None,
                 sleep: Callable[[float], None] = time.sleep, seed: int = 0,
                 log: Callable[[str], None] | None = None):
    """Call ``fn()`` with up to ``policy.max_retries`` retries on
    ``policy.retry_on``. Each failed attempt logs one line (site, attempt,
    error, backoff); the final failure propagates unchanged."""
    policy = policy or RetryPolicy()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    rng = np.random.RandomState(seed)
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except policy.retry_on as e:  # noqa: PERF203 — retry loop
            _count_failure(site)
            # a trace instant per failed attempt; `round` is the caller's
            # jitter seed, which the round sites key by global round
            from ..obs import trace as obtrace

            obtrace.instant("resilience", f"retry:{site}", attempt=attempt + 1, round=seed,
                            error=type(e).__name__)
            if attempt >= policy.max_retries:
                log(f"retry[{site}]: attempt {attempt + 1}/{policy.max_retries + 1} failed "
                    f"({type(e).__name__}: {e}); retries exhausted")
                raise
            d = policy.delay_s(attempt, rng)
            log(f"retry[{site}]: attempt {attempt + 1}/{policy.max_retries + 1} failed "
                f"({type(e).__name__}: {e}); backing off {d:.2f}s")
            sleep(d)
