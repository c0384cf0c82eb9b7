"""Ops surface: the service's metrics snapshot over a loopback HTTP
endpoint (the port's copy of the JAX package's ``serve/metrics.py``).

- ``GET /metrics``: one JSON object, ``AggregationService.metrics_snapshot``:
  round, queue_depth, arrival_rate_per_s, submissions (the admission
  counters), rounds (the close counters), requeue_depth, latency_ms
  (submission-to-merge {p50, p99, count}, the registry histogram
  ``serve_submit_to_merge_ms``), round_phase_ms (the run loop's
  ``runner_phase_*_ms``), serve_stage_ms (``serve_stage_*_ms``: invite,
  compute, collect, prep) and the service's configuration.

The HTTP server is a stdlib ThreadingHTTPServer on its own daemon thread:
it reads host numbers only and never touches the device. Any other path
is a 404. (The reference's Prometheus exposition, ``/metrics.prom``, is not
ported.)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable



class MetricsServer:
    """Loopback HTTP endpoint over a snapshot callable."""

    def __init__(self, snapshot: Callable[[], dict], host: str = "127.0.0.1", port: int = 0):
        self._snapshot = snapshot
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
        snapshot = self._snapshot

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler's API)
                if self.path.rstrip("/") not in ("/metrics", ""):
                    self.send_error(404)
                    return
                try:
                    body = json.dumps(snapshot()).encode()
                except Exception as e:  # noqa: BLE001 (a broken snapshot is a 500, not a
                    # dead handler thread)
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # stdout stays machine-parsable
                pass

        return Handler
