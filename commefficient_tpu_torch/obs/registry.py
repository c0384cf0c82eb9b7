"""Process-wide counter/gauge/histogram registry: the single store of
the port's operational metrics (a copy of the JAX package's
``obs/registry.py``, which is standard-library only).

The run loop writes its per-phase histograms here (``runner_phase_*_ms``)
and the serving layer its stage histograms (``serve_stage_*_ms``),
submission-to-merge latencies, admission counters and arrival meter; the
``/metrics`` endpoint (``serve/metrics.py``) reads them back.

Metric kinds:

- ``Counter``   — monotonically increasing float (``inc``); per-run views
  come from ``Registry.mark()`` deltas.
- ``Gauge``     — last-set value (``set``) plus a running max (``set_max``).
- ``Histogram`` — cumulative count/sum plus a bounded window of recent
  observations for p50/p99 (``observe``/``percentile``/``summary``).
- ``Meter``     — sliding-window event rate (events/s over the trailing
  ``window_s``).

Everything is thread-safe (transport threads, the prefetch thread and the
writer thread record concurrently) and host-only.
"""

from __future__ import annotations

import collections
import threading
import time


class Counter:
    """Monotonic counter. `inc` only; per-run views come from mark deltas."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-set value plus a running maximum (for depth-style metrics)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._max = max(self._max, self._value)

    def set_max(self, v: float) -> None:
        """Record v only as a candidate maximum (value stays last-set)."""
        with self._lock:
            self._max = max(self._max, float(v))

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max


class Histogram:
    """Cumulative count/sum + a bounded window of recent observations for
    percentiles. p50/p99 over a recent window is the honest shape for
    latency metrics (an hours-old compile tail must not pin p99 forever);
    count/sum stay cumulative so rates and means survive the window."""

    def __init__(self, name: str, window: int = 2048) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._window: collections.deque[float] = collections.deque(
            maxlen=max(window, 1))
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._window.append(v)
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float | None:
        """p in [0, 100] over the retained window; None when empty."""
        with self._lock:
            vals = sorted(self._window)
        if not vals:
            return None
        idx = min(len(vals) - 1, max(0, int(len(vals) * p / 100.0)))
        return vals[idx]

    def reset_window(self) -> None:
        """Drop the percentile window, keep the cumulative count/sum — for
        A/B comparisons that need each arm's p50/p99 over its OWN
        observations while rates/means stay whole-run."""
        with self._lock:
            self._window.clear()

    def summary(self) -> dict:
        """{p50, p99, count} — the /metrics-endpoint shape (p50/p99 None
        when nothing was observed yet)."""
        with self._lock:
            vals = sorted(self._window)
            count = self._count
        if not vals:
            return {"p50": None, "p99": None, "count": count}
        return {
            "p50": round(vals[min(len(vals) - 1, len(vals) // 2)], 3),
            "p99": round(vals[min(len(vals) - 1, int(len(vals) * 0.99))], 3),
            "count": count,
        }


class Meter:
    """Sliding-window event rate: record(n) on each event, rate() =
    events/s over the trailing `window_s`. O(events in window) memory,
    thread-safe. record() may run under a caller's lock (the ingest
    queue's on_accept hook), so both ends are O(1) amortized — hence the
    deque. This is serve's old RateWindow, moved behind the registry."""

    def __init__(self, name: str = "", window_s: float = 60.0,
                 clock=time.monotonic) -> None:
        self.name = name
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        self._events: collections.deque[tuple[float, int]] = (
            collections.deque())

    def record(self, n: int = 1) -> None:
        now = self._clock()
        with self._lock:
            self._events.append((now, n))
            self._trim(now)

    def rate(self) -> float:
        now = self._clock()
        with self._lock:
            self._trim(now)
            total = sum(n for _, n in self._events)
        return total / self.window_s

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()


class RegistryMark:
    """Counter snapshot taken by Registry.mark(): delta(name) is the
    increase since the mark — how a per-run view (RunStats, a bench arm) is
    carved out of the process-cumulative registry."""

    def __init__(self, registry: "Registry", values: dict[str, float]):
        self._registry = registry
        self._values = values

    def delta(self, name: str) -> float:
        return self._registry.counter(name).value - self._values.get(name, 0.0)


class Registry:
    """Named metric store: `counter`/`gauge`/`histogram`/`meter` get-or-
    create (a name is permanently bound to its first kind — reusing it as a
    different kind raises, catching the silent-shadowing bug class)."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
              "meter": Meter}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, kind: str, name: str, **kw):
        cls = self._KINDS[kind]
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, requested as "
                    f"{cls.__name__} — one name, one kind")
            return m

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str, window: int = 2048) -> Histogram:
        return self._get("histogram", name, window=window)

    def meter(self, name: str, window_s: float = 60.0) -> Meter:
        return self._get("meter", name, window_s=window_s)

    def mark(self) -> RegistryMark:
        """Snapshot every counter's current value (see RegistryMark)."""
        with self._lock:
            values = {n: m._value for n, m in self._metrics.items()
                      if isinstance(m, Counter)}
        return RegistryMark(self, values)

    def counter_values(self, prefixes: tuple[str, ...] = ("",)) -> dict[str, float]:
        """{name: value} of the counters whose names start with one of
        ``prefixes``: what ``snapshot()`` holds for them, without summarising
        every histogram (the SLO engine and the ledger read this once a
        committed round)."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.value for name, m in sorted(items)
                if isinstance(m, Counter) and name.startswith(prefixes)}

    def snapshot(self) -> dict:
        """One JSON-able dict over every registered metric (counters ->
        value, gauges -> {value, max}, histograms -> summary, meters ->
        rate)."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = {"value": m.value, "max": m.max}
            elif isinstance(m, Histogram):
                out[name] = m.summary()
            elif isinstance(m, Meter):
                out[name] = {"rate_per_s": round(m.rate(), 3)}
        return out


# the runner's per-round phase histograms (runner_phase_<name>_ms): ONE
# list, shared by the writer (runner/loop.py) and every reader (serve's
# /metrics round_phase_ms) so a renamed or added phase cannot silently
# desync the endpoint from the loop
RUNNER_PHASES = ("prepare", "dispatch", "drain", "commit")

# the serving pipeline's per-round stage histograms
# (serve_stage_<name>_ms): invite = cohort sample + window open, compute =
# the payload client program + table fetch (payload rounds only), collect =
# traffic/arrivals + the W-of-N (or buffer-trigger) close, prep = round
# preparation / payload finish. Shared writer/reader list like
# RUNNER_PHASES, for the same cannot-silently-desync reason.
SERVE_STAGES = ("invite", "compute", "collect", "prep")


_DEFAULT = Registry()


def default() -> Registry:
    """The process-wide registry every instrumented layer writes to."""
    return _DEFAULT
