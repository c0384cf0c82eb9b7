"""Preemption handling: SIGTERM -> finish the in-flight rounds -> emergency
checkpoint -> exit with a resumable status. The port's copy of the JAX
package's ``resilience/preemption.py`` for one process; the cross-host
agreement (``coordinated``) arrives with the port's multi-process mesh.

The handler only sets a flag. The run loop checks it where the server state
is consistent, takes an emergency checkpoint and exits ``EXIT_RESUMABLE``,
so a supervisor knows to relaunch with ``--resume``.
"""

from __future__ import annotations

import signal
import sys

# EX_TEMPFAIL: "temporary failure, retry later" — relaunch with --resume
EXIT_RESUMABLE = 75


class PreemptionHandler:
    """Context manager installing a flag-setting handler for ``signals``
    (default SIGTERM) in the main thread; the previous handlers are restored
    on exit."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.triggered = False
        self._prev: dict = {}

    def _on_signal(self, signum, frame):
        if not self.triggered:
            print(f"preemption: received {signal.Signals(signum).name}; will finish the "
                  "in-flight rounds, take an emergency checkpoint, and exit "
                  f"{EXIT_RESUMABLE} (resumable)", file=sys.stderr, flush=True)
            # the signal-safe instant skips the JSONL sink (the handler may
            # have interrupted a write on that very handle) and appends only
            # to the in-memory buffer, under the tracer's reentrant lock
            from ..obs import trace as obtrace

            obtrace.get().instant_signal_safe("resilience", "sigterm",
                                              signal=signal.Signals(signum).name)
        self.triggered = True

    def __enter__(self) -> "PreemptionHandler":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        return False
