"""Run logging, copied from the JAX package's ``utils/logging.py``
(SURVEY.md L0c / §5: `TableLogger` stdout tables + `Timer`).

The reference prints fixed-width epoch tables; we keep that surface and add a
JSONL sink so runs are machine-readable (the rebuild's observability upgrade,
SURVEY.md §5 "Metrics / logging").

The JSONL sink is crash-safe by construction: the file is opened ONCE in
append mode with line buffering, every row lands as a single whole-line
write followed by a flush, and each row carries a `schema` version field —
so a process killed mid-run leaves only complete, parseable JSON lines,
and a consumer can tell which row shape it is reading.
"""

from __future__ import annotations

import json
import time

# bump when a row's FIELD SEMANTICS change (not when callers add columns —
# the row dict is caller-shaped; schema versions the envelope discipline)
JSONL_SCHEMA_VERSION = 1


class Timer:
    """Wall-clock phase timer: t = timer(); ... ; dt = timer()."""

    def __init__(self) -> None:
        self._last = time.perf_counter()
        self.total = 0.0

    def __call__(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.total += dt
        return dt


class TableLogger:
    """Fixed-width column table printed incrementally, one row per epoch.
    The optional JSONL sink appends `{"schema": N, **row}` per row (the
    stdout table prints the caller's columns unchanged)."""

    def __init__(self, jsonl_path: str | None = None) -> None:
        self.columns: list[str] | None = None
        self.jsonl_path = jsonl_path
        self._jsonl = None

    def append(self, row: dict) -> None:
        if self.columns is None:
            self.columns = list(row.keys())
            print("  ".join(f"{c:>12s}" for c in self.columns), flush=True)
        cells = []
        for c in self.columns:
            v = row.get(c, "")
            if isinstance(v, float):
                cells.append(f"{v:>12.4f}")
            else:
                cells.append(f"{str(v):>12s}")
        print("  ".join(cells), flush=True)
        if self.jsonl_path:
            if self._jsonl is None:
                # opened once, line-buffered: every append below is one
                # whole-line write + flush, so a kill between rows can
                # never leave a torn line
                self._jsonl = open(self.jsonl_path, "a", buffering=1)
            self._jsonl.write(
                json.dumps({"schema": JSONL_SCHEMA_VERSION, **row}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
