"""Trace-driven traffic generator: diurnal load, bursts, device classes
(the port's copy of the JAX package's ``serve/traffic.py``).

Two faces over one deterministic core:

- round-driven (``respond_to_invites``): given a round's invite list,
  derive each invitee's submission latency from its device class (a pure
  function of (seed, client_id, round), ``serve/clients.py``) and push the
  submissions through a transport, with the payloads and the wire faults
  of a payload round applied at this seam;
- open-world (``arrival_events``): a Poisson arrival stream over the whole
  population whose rate follows a diurnal sinusoid with bursts,
  window-batched.

Everything is virtual time: latencies are numbers handed to the
assembler's virtual close, never slept through.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import clients as cl


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Traffic shape. Parsed from a CLI-friendly 'k=v,k=v' spec."""

    population: int = 10_000      # client-ID universe for open-world arrivals
    base_rate: float = 100.0      # mean arrivals/s at the diurnal midline
    diurnal_amplitude: float = 0.6  # 0..1: peak/trough swing around the mean
    diurnal_period_s: float = 86_400.0
    burst_rate: float = 0.0       # expected bursts per second (Poisson)
    burst_size: int = 50          # arrivals per burst (all in one instant)
    seed: int = 0

    @classmethod
    def parse(cls, spec: str) -> "TraceConfig":
        """'population=10000000,base_rate=200,burst_rate=0.1' -> TraceConfig.
        Unknown keys are rejected loudly (a typoed knob must not silently
        run the default trace)."""
        if not spec:
            return cls()
        kw: dict = {}
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq or key not in fields:
                raise ValueError(
                    f"--serve_trace: unknown key {key!r} "
                    f"(valid: {', '.join(sorted(fields))})")
            caster = int if fields[key] == "int" or fields[key] is int else float
            try:
                kw[key] = caster(val.strip())
            except ValueError as e:
                raise ValueError(
                    f"--serve_trace: bad value for {key}: {val!r}") from e
        return cls(**kw)


class TrafficGenerator:
    """Deterministic traffic over a TraceConfig (see module docstring)."""

    def __init__(self, cfg: TraceConfig, classes=cl.DEFAULT_CLASSES):
        if cfg.population < 1:
            raise ValueError(f"population must be >= 1, got {cfg.population}")
        self.cfg = cfg
        self.classes = classes

    # -- diurnal rate ---------------------------------------------------------

    def rate_at(self, t_s: float) -> float:
        """Instantaneous arrival rate (events/s): diurnal sinusoid with the
        trough at t=0 (midnight) and peak half a period later."""
        c = self.cfg
        phase = 2.0 * math.pi * (t_s / c.diurnal_period_s)
        return max(c.base_rate * (1.0 - c.diurnal_amplitude * math.cos(phase)),
                   0.0)

    # -- open-world arrival stream -------------------------------------------

    def arrival_events(self, t0_s: float, duration_s: float,
                       window_s: float = 1.0):
        """Yield (t_s, client_ids ndarray) per window in [t0, t0+duration):
        Poisson(rate(t) * window) baseline arrivals plus Poisson bursts,
        client ids drawn uniformly from the population. Per-window
        RandomState pinned to (seed, window index): replaying any window is
        independent of how much of the trace was consumed before it."""
        c = self.cfg
        n_windows = max(int(math.ceil(duration_s / window_s)), 0)
        for w in range(n_windows):
            t = t0_s + w * window_s
            rs = np.random.RandomState(
                int(cl.fold_in_host(c.seed, int(t0_s / max(window_s, 1e-9))
                                    + w, 0xA11) % (2**32)))
            n = rs.poisson(self.rate_at(t) * window_s)
            n += rs.poisson(c.burst_rate * window_s) * c.burst_size
            if n <= 0:
                continue
            ids = rs.randint(0, c.population, size=int(n)).astype(np.int64)
            yield t, ids

    # -- round-driven responses ----------------------------------------------

    def invite_latencies(self, rnd: int, invited_ids) -> np.ndarray:
        """[N] submission latencies for the invitees (np.inf = no-show),
        from each client's device class — ONE vectorized derivation, no
        per-client state."""
        return cl.response_latency_s(
            self.cfg.seed, np.asarray(invited_ids, np.int64), rnd,
            self.classes)

    def respond_to_invites(self, rnd: int, invited_ids, submit,
                           deadline_s: float, payloads=None, wire=None,
                           abort=None) -> int:
        """Simulate the invited cohort answering round `rnd`: every invitee
        whose derived latency is finite AND within `deadline_s` submits
        (latency-order, so wall-clock transports see a realistic arrival
        sequence). Returns the number of submissions pushed. `submit` is
        transport.submit — rejections (dup/late/full) are the transport's
        business, counted by the ingest queue.

        Payload rounds (--serve_payload sketch): `payloads` is the
        per-invitee sequence of wire payloads ([r, c] ndarrays — the socket
        helper frames them; inproc ships the array), and `wire` an optional
        FaultPlan.wire_plan dict applying damage AT THIS SEAM — between the
        client's compute and the server's ingest, the hop the validation
        gauntlet exists for:

        - corrupt/truncate damage the FRAME (the array is encoded first so
          the damage hits real wire bytes, whatever the transport);
        - dup re-sends the identical submission (at-least-once double send —
          the server's duplicate detection must keep the merge single-count);
        - delay_s adds to the submission latency (the straggler discipline
          decides whether it still makes the close);
        - drop kills the send: through `abort` (a mid-send connection death,
          socket realism) when given, else the submission just never leaves
          the client — either way the server sees a no-show;
        - withhold suppresses the send entirely (no abort, no wire bytes):
          the client deliberately sits the round out — the first half of
          the client_stale_poison attack, whose second half the serving
          layer submits into the stale band next round."""
        from ..resilience.faults import FaultPlan
        from ..sketch.payload import encode_frame
        from .ingest import Submission

        lat = self.invite_latencies(rnd, invited_ids)
        wire = wire or {}
        if wire:
            lat = np.array(lat, copy=True)
            for p, actions in wire.items():
                if actions.get("delay_s"):
                    lat[p] += actions["delay_s"]
        order = np.argsort(lat, kind="stable")
        sent = 0
        for i in order:
            if not np.isfinite(lat[i]) or lat[i] > deadline_s:
                break  # sorted: everything after is slower
            payload = payloads[i] if payloads is not None else None
            actions = wire.get(int(i), {})
            sub = Submission(client_id=int(invited_ids[i]), round=rnd,
                             latency_s=float(lat[i]), payload=payload)
            if actions.get("withhold"):
                continue  # deliberate silence: not even an aborted send
            if actions.get("drop"):
                if abort is not None:
                    abort(sub)  # the connection dies mid-send
                continue
            if actions.get("corrupt") or actions.get("truncate"):
                frame = (payload if isinstance(payload, dict)
                         else encode_frame(payload))
                if actions.get("corrupt"):
                    frame = FaultPlan.corrupt_frame(frame)
                if actions.get("truncate"):
                    frame = FaultPlan.truncate_frame(frame)
                sub = Submission(client_id=int(invited_ids[i]), round=rnd,
                                 latency_s=float(lat[i]), payload=frame)
            submit(sub)
            if actions.get("dup"):
                submit(sub)  # identical at-least-once re-send
            sent += 1
        return sent
