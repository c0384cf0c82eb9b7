"""Trace exporters: Chrome-trace/Perfetto JSON (the port's copy of the
JAX package's ``obs/export.py``).

The on-disk format is the Trace Event Format's JSON-object flavor
(`{"traceEvents": [...]}`), which both `chrome://tracing` and
https://ui.perfetto.dev open directly. Every event carries `ph` (X =
complete span, i = instant, M = metadata), `ts`/`dur` in microseconds,
`pid` (this process), `tid` (the TRACK id — tracks are rendered as named
rows via thread_name metadata: runner, device, writer, serve-ingest,
assembler, federated, resilience), `name`, `cat` (the track name, so
Perfetto's category filter works per subsystem), and `args` (round
numbers, client ids, submission ids).

tests/test_torch_obs.py holds the output to the JAX package's; the JSONL event sink lives in
trace.Tracer (streamed per event, not exported here).
"""

from __future__ import annotations

import json
import os


def chrome_trace_events(events: list[dict], tracks: dict[str, int],
                        pid: int | None = None) -> list[dict]:
    """Final traceEvents list: track-naming metadata first, then the
    buffered events stamped with this process's pid."""
    if pid is None:
        pid = os.getpid()
    out: list[dict] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": "commefficient-tpu"}},
    ]
    for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": track}})
        # sort_index pins the track order in the UI to ours
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})
    for ev in events:
        out.append({**ev, "pid": pid})
    return out


def write_chrome_trace(path: str, events: list[dict],
                       tracks: dict[str, int], dropped: int = 0) -> str:
    """Write one Chrome-trace JSON file (atomically: temp + rename, so a
    crash mid-write never leaves a half-trace that Perfetto half-opens)."""
    doc = {
        "traceEvents": chrome_trace_events(events, tracks),
        "displayTimeUnit": "ms",
    }
    if dropped:
        doc["otherData"] = {
            "dropped_events": dropped,
            "note": "event buffer hit max_events; the tail of the run is "
                    "not in this trace",
        }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
