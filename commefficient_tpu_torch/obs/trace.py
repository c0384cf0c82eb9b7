"""Span/event tracer: where every millisecond of the round goes (the
port's copy of the JAX package's ``obs/trace.py``, which is
standard-library only).

Host-side spans (`span`, a context manager), point events (`instant`), and
DEFERRED spans (`complete`, emitted after the fact with an explicit start
timestamp) on named tracks — runner, device, writer, serve-ingest,
assembler, federated, resilience. The run loop uses `complete` for the
device phase: a dispatch records only a host timestamp, and the span is
emitted at the loop's existing drain boundary when the in-flight rounds
commit — tracing never adds a host synchronization to the round path and
never touches RNG or device state, which is why a traced run is pinned
bitwise equal to an untraced one (tests/test_torch_obs.py).

Disabled (the default) the tracer is a near-zero-cost no-op: one attribute
check per call site. `configure(trace_path=..., jsonl_path=...)` arms it —
the CLIs do this from `--trace` / `--trace_events`. Buffered events are
written as ONE Chrome-trace/Perfetto JSON file at `flush()` (exit path,
never the dispatch path); the optional JSONL sink streams one
schema-versioned object per event through a line-buffered handle opened
once at configure time, the same whole-lines discipline as
`utils.logging.TableLogger` (no `open()` ever runs on the dispatch thread).

Memory is bounded: past `max_events` (default 1<<20) new events are
dropped and counted (`dropped_events`), loudly noted in the flushed trace
— a days-long run cannot exhaust the host through its own telemetry.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time

from . import export

# canonical track order (chrome-trace tid assignment; unknown tracks get
# the next free id at first use)
TRACKS = ("runner", "device", "writer", "serve-ingest", "gauntlet",
          "assembler", "federated", "resilience")

EVENT_SCHEMA_VERSION = 1


class Tracer:
    def __init__(self, max_events: int = 1 << 20) -> None:
        # REENTRANT: the preemption SIGTERM handler emits an instant from
        # the main thread, which may have been interrupted INSIDE this
        # lock's critical section — a plain Lock would self-deadlock.
        # With an RLock the nested append is safe (list.append is
        # atomic); the handler uses instant_signal_safe, which skips the
        # JSONL sink so an interrupted write can never be interleaved.
        self._lock = threading.RLock()
        self._events: list[dict] = []
        self._tracks: dict[str, int] = {t: i + 1 for i, t in enumerate(TRACKS)}
        self._t0_ns = time.perf_counter_ns()
        self._trace_path: str | None = None
        self._jsonl = None
        self.max_events = max_events
        self.dropped_events = 0
        self.enabled = False

    # -- lifecycle -------------------------------------------------------------

    def configure(self, trace_path: str | None = None,
                  jsonl_path: str | None = None) -> None:
        """Arm (or, with no paths, disarm) the tracer. Resets the event
        buffer and the timestamp origin; closes any previous JSONL sink.
        Called from the CLIs at startup — never from the dispatch path
        (the JSONL handle is opened HERE, line-buffered, so per-event
        writes later are single whole-line writes on a live handle)."""
        with self._lock:
            if self._jsonl is not None:
                try:
                    self._jsonl.close()
                except OSError:
                    pass
                self._jsonl = None
            self._events = []
            self.dropped_events = 0
            self._t0_ns = time.perf_counter_ns()
            self._trace_path = trace_path or None
            if jsonl_path:
                self._jsonl = open(jsonl_path, "a", buffering=1)
            self.enabled = bool(trace_path or jsonl_path)

    def flush(self) -> str | None:
        """Write the buffered events as one Chrome-trace JSON file (the
        `--trace` path); returns the path written, or None when the tracer
        is disarmed / has no trace path. Idempotent — safe from both the
        CLI's finally block and atexit."""
        with self._lock:
            path = self._trace_path
            events = list(self._events)
            tracks = dict(self._tracks)
            dropped = self.dropped_events
        if not path:
            return None
        export.write_chrome_trace(path, events, tracks, dropped=dropped)
        return path

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list[dict]:
        """Snapshot of the raw buffered events (tests / programmatic use)."""
        with self._lock:
            return list(self._events)

    def export_snapshot(self) -> tuple[list[dict], dict[str, int], int]:
        """(events, tracks, dropped) copied atomically under the lock —
        what an exporter other than flush() (the postmortem bundle) needs;
        an unlocked read could catch a track being added mid-span on
        another thread."""
        with self._lock:
            return list(self._events), dict(self._tracks), self.dropped_events

    # -- timestamps ------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since configure() — the trace timebase."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    # -- emission --------------------------------------------------------------

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[track] = tid
        return tid

    def _emit(self, ph: str, track: str, name: str, ts_us: float,
              dur_us: float | None, args: dict, sink: bool = True) -> None:
        with self._lock:
            ev: dict = {"ph": ph, "tid": self._tid(track), "cat": track,
                        "name": name, "ts": round(ts_us, 3), "args": args}
            if dur_us is not None:
                ev["dur"] = round(dur_us, 3)
            if sink and self._jsonl is not None:
                # the JSONL stream is on DISK, so it outlives the bounded
                # in-memory buffer — write it before (independently of)
                # the cap check below. One whole line per event, flushed
                # by line buffering: a killed process leaves only complete
                # JSON lines (the TableLogger discipline).
                try:
                    self._jsonl.write(json.dumps(
                        {"schema": EVENT_SCHEMA_VERSION, "track": track,
                         **ev}) + "\n")
                except OSError as e:
                    self._jsonl = None
                    print(f"obs: event sink write failed ({e}); JSONL "
                          "stream disabled for the rest of the run",
                          file=sys.stderr, flush=True)
            if len(self._events) >= self.max_events:
                if self.dropped_events == 0:
                    # loud on the FIRST drop: a --trace_events-only run
                    # never reaches flush()'s dropped-events note
                    print(
                        f"obs: trace buffer full ({self.max_events} "
                        "events); the Chrome trace will miss the rest of "
                        "the run (the JSONL stream, if armed, continues)",
                        file=sys.stderr, flush=True)
                self.dropped_events += 1
                return
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, track: str, name: str, **args):
        """Host-side duration span. No-op (still yields) when disarmed."""
        if not self.enabled:
            yield
            return
        t0 = self.now_us()
        try:
            yield
        finally:
            now = self.now_us()
            self._emit("X", track, name, t0, now - t0, args)

    def complete(self, track: str, name: str, ts_us: float, dur_us: float,
                 **args) -> None:
        """Deferred span: emitted now, covering [ts_us, ts_us + dur_us] —
        how device-phase durations resolve at the drain boundary without a
        mid-round host sync."""
        if not self.enabled:
            return
        self._emit("X", track, name, ts_us, max(dur_us, 0.0), args)

    def instant(self, track: str, name: str, **args) -> None:
        """Point event (fault injections, retries, preemption, admission
        decisions)."""
        if not self.enabled:
            return
        self._emit("i", track, name, self.now_us(), None, args)

    def instant_signal_safe(self, track: str, name: str, **args) -> None:
        """Instant that SKIPS the JSONL sink: for signal handlers, which
        may have interrupted the main thread mid-write on the same
        line-buffered handle — an interleaved write there would tear a
        line and break the whole-lines crash-safety contract. The
        in-memory append (and thus the Chrome trace) is safe under the
        reentrant lock."""
        if not self.enabled:
            return
        self._emit("i", track, name, self.now_us(), None, args, sink=False)


_GLOBAL = Tracer()


def get() -> Tracer:
    return _GLOBAL


def configure(trace_path: str | None = None,
              jsonl_path: str | None = None) -> None:
    _GLOBAL.configure(trace_path, jsonl_path)


def span(track: str, name: str, **args):
    return _GLOBAL.span(track, name, **args)


def complete(track: str, name: str, ts_us: float, dur_us: float, **args):
    _GLOBAL.complete(track, name, ts_us, dur_us, **args)


def instant(track: str, name: str, **args):
    _GLOBAL.instant(track, name, **args)


def now_us() -> float:
    return _GLOBAL.now_us()


def flush() -> str | None:
    return _GLOBAL.flush()
