"""Span and event call sites (the API of the JAX package's ``obs/trace.py``,
which is standard-library only).

The serving layer marks host-side spans (``span``, a context manager) and
point events (``instant``) on named tracks: serve-ingest, serve-pipeline,
assembler. The port has no tracer to arm yet (``--trace`` stays refused,
ROADMAP Queue 1 item 13), so the tracer is always off and every call site
costs one attribute check.
"""

from __future__ import annotations

import contextlib


class Tracer:
    enabled = False

    @contextlib.contextmanager
    def span(self, track: str, name: str, **args):
        yield

    def instant(self, track: str, name: str, **args) -> None:
        pass


_GLOBAL = Tracer()


def get() -> Tracer:
    return _GLOBAL


def span(track: str, name: str, **args):
    return _GLOBAL.span(track, name, **args)


def instant(track: str, name: str, **args):
    _GLOBAL.instant(track, name, **args)
