"""obs — the port's observability layer (the counterpart of the JAX
package's ``obs/``), under one contract: everything is host-side, nothing
adds a host sync to the round path, and the estimators only read round
state, so a traced, health-armed, ledger-armed run is bitwise equal to a
plain one (params, server and client state, every logged row).

- ``trace``    — span/event tracer on named tracks (runner, device, writer,
  serve-ingest, assembler, federated, resilience), exported as a
  Chrome-trace/Perfetto JSON (``--trace PATH``, ``export``) and/or a
  line-buffered JSONL event stream (``--trace_events PATH``). Device-phase
  durations are deferred: a dispatch records a host timestamp, the span is
  resolved at the run loop's drain.
- ``registry`` — process-wide counters, gauges, histograms and meters; the
  run loop, the serving layer, the health monitor and the SLO engine write
  here, and ``/metrics`` (JSON) and ``/metrics.prom`` read it.
- ``profiler`` — a ``torch.profiler`` capture window around whole rounds
  (``--profile_rounds START:END``).
- ``health``   — sketch-health estimators computed in the round step at
  the ``--health_every`` cadence, and their host monitor.
- ``slo``      — declarative rules over the committed round series
  (``--slo warn|halt``, ``--slo_rules``).
- ``ledger``   — the durable per-round ledger (``--ledger``), the
  postmortem bundle and the ``python -m commefficient_tpu_torch.obs.ledger``
  CLI.
"""

from __future__ import annotations

import dataclasses

from . import export, profiler, registry, slo, trace
from .profiler import ProfileWindow
from .registry import Registry
from .slo import SloEngine
from .trace import Tracer

# names resolved on first access (PEP 562): ``ledger`` doubles as the
# ``python -m commefficient_tpu_torch.obs.ledger`` CLI, and an eager import
# would put it in sys.modules before runpy executes it as __main__ (the
# found-in-sys.modules RuntimeWarning); ``health`` imports torch, and a
# shard worker process (serve/scale/procshard_worker.py) imports this
# package for its registry and must stay torch-free
_LAZY = {"ledger": "ledger", "RoundLedger": "ledger", "write_postmortem_bundle": "ledger",
         "health": "health", "HealthMonitor": "health"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f".{mod}", __name__)
    return module if name == mod else getattr(module, name)


def configure_from_args(args) -> bool:
    """Arm (or disarm) the global tracer from the CLI flags; returns whether
    tracing is on. Called once per main(), so back-to-back runs in one
    process (tests) each get a fresh event buffer."""
    trace.configure(getattr(args, "trace", "") or None,
                    getattr(args, "trace_events", "") or None)
    return trace.get().enabled


def flush_trace() -> str | None:
    """Write the Chrome trace (if armed) and say where it landed, on stderr
    (the stdout metrics table stays machine-parsable)."""
    import sys

    n = trace.get().event_count()
    path = trace.flush()
    if path:
        print(f"obs: trace written to {path} ({n} events)", file=sys.stderr, flush=True)
    return path


@dataclasses.dataclass
class ObsWiring:
    """What attach_from_args built and attached for one run: the
    sketch-health monitor, SLO engine and round ledger (any may be None),
    plus the postmortem hook the run loop calls on its abort and exit-75
    paths and the CLIs call on an unhandled exception. ``close()`` in the
    run's finally."""

    monitor: object | None = None
    slo_engine: object | None = None
    round_ledger: object | None = None
    ledger_path: str | None = None
    postmortem_dir: str | None = None
    config: dict | None = None

    @property
    def postmortem(self):
        """The run loop's postmortem hook (callable(reason) -> path), or
        None when no bundle directory is armed (no --ledger)."""
        if self.postmortem_dir is None:
            return None

        def write(reason: str) -> str:
            from .ledger import write_postmortem_bundle

            return write_postmortem_bundle(
                self.postmortem_dir, reason=reason,
                ledger_path=self.ledger_path, config=self.config)

        return write

    def close(self) -> None:
        if self.round_ledger is not None:
            self.round_ledger.close()


def attach_from_args(args, session) -> ObsWiring:
    """Build and ATTACH the observability the flags ask for: --health_every
    N arms the sketch-health monitor, --slo warn|halt the SLO engine
    (--slo_rules overrides the default rule set), --ledger PATH the durable
    round ledger and, with it, the postmortem bundle at PATH.postmortem/.
    Call AFTER the checkpoint restore: the ledger's resume truncation keys
    off the restored round, which makes a preempt -> resume run one
    gap-free, duplicate-free file."""
    wiring = ObsWiring(config={
        k: v for k, v in vars(args).items()
        if isinstance(v, (str, int, float, bool, type(None)))})
    if getattr(args, "health_every", 0):
        from .health import HealthMonitor

        wiring.monitor = HealthMonitor(
            mode_cfg=session.cfg.mode, num_workers=session.num_workers,
            health_every=args.health_every)
        session.health_monitor = wiring.monitor
    if getattr(args, "slo", "off") != "off":
        wiring.slo_engine = SloEngine(
            slo.parse_rules(getattr(args, "slo_rules", "")), mode=args.slo)
        session.slo = wiring.slo_engine
    path = getattr(args, "ledger", "")
    if path:
        from .ledger import RoundLedger

        wiring.ledger_path = path
        wiring.postmortem_dir = path + ".postmortem"
        wiring.round_ledger = RoundLedger(
            path, resume_round=session.round,
            static={
                "mode": args.mode,
                "sketch": {"rows": args.num_rows, "cols": args.num_cols,
                           "k": args.k} if args.mode == "sketch" else None,
                "merge_policy": args.merge_policy,
                "merge_trim": args.merge_trim,
                "quarantine_scope": args.quarantine_scope,
                "quarantine_window": args.quarantine_window,
                "num_workers": session.num_workers,
                "seed": args.seed,
                "serve": getattr(args, "serve", "off"),
                "serve_payload": getattr(args, "serve_payload", "announce"),
                "health_every": getattr(args, "health_every", 0),
            })
        session.ledger = wiring.round_ledger
    return wiring


__all__ = [
    "HealthMonitor",
    "ObsWiring",
    "ProfileWindow",
    "Registry",
    "RoundLedger",
    "SloEngine",
    "Tracer",
    "attach_from_args",
    "configure_from_args",
    "export",
    "flush_trace",
    "health",
    "ledger",
    "profiler",
    "registry",
    "slo",
    "trace",
    "write_postmortem_bundle",
]
