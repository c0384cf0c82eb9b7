"""Ops surface: the service's metrics over a loopback HTTP endpoint (the
port's copy of the JAX package's ``serve/metrics.py``), in two formats
over the same numbers:

- ``GET /metrics.prom``: Prometheus text exposition (format 0.0.4)
  rendered from the process-wide obs registry by ``render_prometheus``:
  counters as ``counter``, gauges as ``gauge`` (plus a ``<name>_max``
  gauge), histograms as ``summary`` (p50/p99 quantiles, ``_sum``,
  ``_count``), meters as a ``<name>_rate_per_s`` gauge;
- ``GET /metrics``: one JSON object, ``AggregationService.metrics_snapshot``:
  round, queue_depth, arrival_rate_per_s, submissions (the admission
  counters), rounds (the close counters), requeue_depth, latency_ms
  (submission-to-merge {p50, p99, count}, the registry histogram
  ``serve_submit_to_merge_ms``), round_phase_ms (the run loop's
  ``runner_phase_*_ms``), serve_stage_ms (``serve_stage_*_ms``: invite,
  compute, collect, prep) and the service's configuration.

The HTTP server is a stdlib ThreadingHTTPServer on its own daemon thread:
it reads host numbers only and never touches the device. Any other path
is a 404.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from ..obs import registry as obreg

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = _NAME_SANITIZE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def render_prometheus(registry: obreg.Registry | None = None) -> str:
    """Prometheus text exposition (format 0.0.4) of every registered
    metric, the body ``GET /metrics.prom`` serves. Pure over the registry;
    one line per sample, newline-terminated as the format requires."""
    if registry is None:
        registry = obreg.default()
    with registry._lock:
        items = sorted(registry._metrics.items())
    lines: list[str] = []
    for name, m in items:
        pname = _prom_name(name)
        if isinstance(m, obreg.Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {m.value:g}")
        elif isinstance(m, obreg.Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {m.value:g}")
            lines.append(f"# TYPE {pname}_max gauge")
            lines.append(f"{pname}_max {m.max:g}")
        elif isinstance(m, obreg.Histogram):
            # quantiles over the bounded recent window, count and sum over
            # the lifetime (the split Histogram.summary makes)
            lines.append(f"# TYPE {pname} summary")
            for q, p in (("0.5", 50.0), ("0.99", 99.0)):
                v = m.percentile(p)
                if v is not None:
                    lines.append(f'{pname}{{quantile="{q}"}} {v:g}')
            lines.append(f"{pname}_sum {m.sum:g}")
            lines.append(f"{pname}_count {m.count}")
        elif isinstance(m, obreg.Meter):
            lines.append(f"# TYPE {pname}_rate_per_s gauge")
            lines.append(f"{pname}_rate_per_s {m.rate():g}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Loopback HTTP endpoint over a snapshot callable and the registry of
    the Prometheus exposition (default: the process-wide one)."""

    def __init__(self, snapshot: Callable[[], dict], host: str = "127.0.0.1", port: int = 0,
                 registry: obreg.Registry | None = None):
        self._snapshot = snapshot
        self._registry = registry if registry is not None else obreg.default()
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="serve-metrics",
                                        daemon=True)

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def _make_handler(self):
        snapshot, registry = self._snapshot, self._registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler's API)
                path = self.path.rstrip("/")
                if path == "/metrics.prom":
                    render, ctype = (lambda: render_prometheus(registry),
                                     "text/plain; version=0.0.4; charset=utf-8")
                elif path in ("/metrics", ""):
                    render, ctype = lambda: json.dumps(snapshot()), "application/json"
                else:
                    self.send_error(404)
                    return
                try:
                    body = render().encode()
                except Exception as e:  # noqa: BLE001 (a broken snapshot is a 500, not a
                    # dead handler thread)
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # stdout stays machine-parsable
                pass

        return Handler
