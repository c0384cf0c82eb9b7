"""Deterministic fault injection: the port's copy of the JAX package's
``resilience/faults.py`` for the run loop's sites.

A plan is parsed from a compact CLI string (``--fault_plan``) of
``;``-separated entries, each ``kind[@round,round,...][:key=val,...]``:

    preempt@3                   SIGTERM this process as round 3 dispatches
                                (the preemption handler lets the dispatched
                                rounds commit, takes an emergency checkpoint,
                                exits resumable)
    stall@2:secs=1.5            sleep 1.5 s in round 2's data-load path
                                (exercises the watchdog)
    eval_stall@4:secs=1.5       sleep 1.5 s in the eval loader as the
                                round-4 eval boundary starts
    data_fail@1:times=2         raise a transient error twice in round 1's
                                data load (recovered by the retry wrapper)
    nonfinite@4                 poison round 4's client batches with NaN
                                (value=inf for an Inf burst) so the round's
                                updates go non-finite through the real
                                gradient path
    ckpt_fail@2:times=1         transient error on the round-2 checkpoint
                                write (recovered by retry)
    ckpt_corrupt@2              flip a byte of the round-2 checkpoint after
                                it commits (caught by manifest verification
                                at restore)
    ckpt_partial@2              truncate a round-2 checkpoint file
                                (simulated partial write)
    seed=7                      recorded on the plan for reporting

Round numbers are global round indices (session.round), so a plan replays
correctly across checkpoint resume: ``preempt@3`` does not fire again in a
resumed run that starts at round 4. ``FaultPlan.parse("")`` is None: no
plan, no change.

The reference's other kinds (cohort faults, wire faults, Byzantine
clients, distributed bootstrap, edge and shard kills) need sites the port
does not have yet. They are refused at parse with a message that names
them, never accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time

import numpy as np

# allowed param keys per kind: a typo'd key must fail parse, not silently
# fall back to the default and under-inject
KINDS = {
    "preempt": (),
    "stall": ("secs",),
    "eval_stall": ("secs",),
    "data_fail": ("times",),
    "nonfinite": ("value",),
    "ckpt_fail": ("times",),
    "ckpt_corrupt": (),
    "ckpt_partial": (),
}

# the reference's kinds whose sites the port does not have yet
NOT_PORTED = ("dist_init", "client_drop", "client_straggle", "client_poison",
              "host_preempt", "wire_corrupt", "wire_truncate", "wire_dup",
              "wire_delay", "conn_drop", "client_signflip", "client_scale",
              "client_collude", "client_normride", "client_stale_poison",
              "edge_kill", "shard_kill")


class InjectedFault(RuntimeError):
    """Base class for every injected failure."""


class InjectedTransientError(InjectedFault):
    """An injected failure that a retry wrapper is expected to recover."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    rounds: tuple[int, ...] = ()  # empty = any round
    params: dict = dataclasses.field(default_factory=dict)

    def matches(self, rnd: int | None) -> bool:
        return not self.rounds or (rnd is not None and rnd in self.rounds)


def _parse_entry(entry: str) -> FaultSpec:
    head, _, tail = entry.partition(":")
    kind, _, rounds_s = head.partition("@")
    kind = kind.strip()
    if kind in NOT_PORTED:
        raise ValueError(
            f"fault kind {kind!r} in --fault_plan entry {entry!r} is not ported: the "
            f"port has no site for it yet (it runs: {', '.join(KINDS)})")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in --fault_plan entry {entry!r} "
                         f"(known: {', '.join(KINDS)})")
    try:
        rounds = tuple(int(r) for r in rounds_s.split(",") if r.strip()) if rounds_s else ()
    except ValueError:
        raise ValueError(f"bad @round list {rounds_s!r} in --fault_plan entry {entry!r} "
                         "(expected comma-separated integers)") from None
    params: dict = {}
    if tail:
        for kv in tail.split(","):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"bad param {kv!r} in --fault_plan entry {entry!r}")
            k, v = k.strip(), v.strip()
            if k not in KINDS[kind]:
                raise ValueError(
                    f"unknown param {k!r} for fault kind {kind!r} in --fault_plan entry "
                    f"{entry!r} (allowed: {', '.join(KINDS[kind]) or 'none'})")
            # coerce at parse time: a bad value rejects the plan at launch,
            # not hours later at the scheduled round
            try:
                if k == "times":
                    params[k] = int(v)
                elif k == "secs":
                    params[k] = float(v)
                elif k == "value":
                    if v not in ("nan", "inf"):
                        raise ValueError("expected one of nan/inf")
                    params[k] = v
            except ValueError as e:
                raise ValueError(f"bad value {v!r} for param {k!r} in --fault_plan entry "
                                 f"{entry!r} ({e})") from None
    return FaultSpec(kind=kind, rounds=rounds, params=params)


class FaultPlan:
    """The parsed plan plus the bookkeeping that makes injection
    deterministic: per-(kind, round) attempt counters for transient faults
    and a fired-set for one-shot faults, so a site hit twice (a retried
    call) sees exactly the scheduled number of failures."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0, text: str = ""):
        self.specs = list(specs)
        self.seed = seed  # recorded for reporting; no site draws from it
        self.text = text
        self._attempts: dict[tuple, int] = {}
        self._fired: set[tuple] = set()

    def __repr__(self):
        return f"FaultPlan({self.text!r})"

    @classmethod
    def parse(cls, text: str | None) -> "FaultPlan | None":
        """None/empty -> no plan."""
        if not text or not text.strip():
            return None
        seed, specs = 0, []
        for entry in text.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                try:
                    seed = int(entry.split("=", 1)[1])
                except ValueError:
                    raise ValueError(f"bad seed in --fault_plan entry {entry!r} "
                                     "(expected an integer)") from None
                continue
            specs.append(_parse_entry(entry))
        return cls(specs, seed=seed, text=text)

    def spec(self, kind: str, rnd: int | None = None) -> FaultSpec | None:
        for s in self.specs:
            if s.kind == kind and s.matches(rnd):
                return s
        return None

    def _log(self, msg: str):
        print(f"fault-injection: {msg}", file=sys.stderr, flush=True)

    def _once(self, kind: str, rnd: int | None) -> FaultSpec | None:
        """The matching spec of a one-shot site, marked fired; None when
        there is none or it already fired."""
        s = self.spec(kind, rnd)
        if s is None or (kind, rnd) in self._fired:
            return None
        self._fired.add((kind, rnd))
        return s

    # ---------------------------------------------------------- named sites

    def fire_transient(self, kind: str, rnd: int | None = None):
        """Raise InjectedTransientError while the spec's ``times`` budget
        (default 1) for this (kind, round) has failures left."""
        s = self.spec(kind, rnd)
        if s is None:
            return
        key = (kind, rnd if s.rounds else None)
        n = self._attempts.get(key, 0)
        times = int(s.params.get("times", 1))
        if n < times:
            self._attempts[key] = n + 1
            self._log(f"{kind} transient failure {n + 1}/{times} (round {rnd})")
            raise InjectedTransientError(f"injected {kind} failure {n + 1}/{times} "
                                         f"(round {rnd})")

    def data_load(self, rnd: int):
        """Data-loader site: a scheduled stall sleeps once; a scheduled
        data_fail raises transiently. Called before the loader draws any host
        RNG, so a retried attempt replays the identical batch."""
        s = self._once("stall", rnd)
        if s is not None:
            secs = float(s.params.get("secs", 1.0))
            self._log(f"stalling data load {secs}s (round {rnd})")
            time.sleep(secs)
        self.fire_transient("data_fail", rnd)

    def eval_load(self, rnd: int):
        """Eval-loader site: a scheduled eval_stall sleeps once per round as
        the eval pass starts."""
        s = self._once("eval_stall", rnd)
        if s is not None:
            secs = float(s.params.get("secs", 1.0))
            self._log(f"stalling eval load {secs}s (round {rnd})")
            time.sleep(secs)

    def poison(self, rnd: int, batch: dict) -> dict:
        """NaN/Inf burst: fill every float array of the assembled client
        batch so the round's updates go non-finite through the real gradient
        path. Keys starting with "_" are the engine's control rows (the
        validity mask) and stay as they are."""
        s = self.spec("nonfinite", rnd)
        if s is None:
            return batch
        val = np.inf if s.params.get("value", "nan") == "inf" else np.nan
        out = {k: (np.full_like(v, val) if not k.startswith("_")
                   and np.issubdtype(v.dtype, np.floating) else v)
               for k, v in batch.items()}
        self._log(f"poisoning round {rnd} client batch with {val}")
        return out

    def preempt(self, rnd: int):
        """Simulated preemption: deliver a real SIGTERM to this process as
        the scheduled round dispatches (one-shot)."""
        if self._once("preempt", rnd) is not None:
            self._log(f"injecting SIGTERM (preempt, round {rnd})")
            os.kill(os.getpid(), signal.SIGTERM)

    def corrupt_checkpoint(self, rnd: int, path: str):
        """Post-commit checkpoint damage (one-shot per kind and round):
        ckpt_corrupt flips one byte of the largest data file, ckpt_partial
        truncates it to half. Both leave manifest.json intact: integrity
        verification at restore must catch the mismatch."""
        for kind in ("ckpt_corrupt", "ckpt_partial"):
            if self._once(kind, rnd) is None:
                continue
            target = self._largest_data_file(path)
            if target is None:
                continue
            if kind == "ckpt_corrupt":
                with open(target, "r+b") as f:
                    f.seek(os.path.getsize(target) // 2)
                    b = f.read(1)
                    f.seek(-1, os.SEEK_CUR)
                    f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
                self._log(f"corrupted checkpoint byte: {target} (round {rnd})")
            else:
                with open(target, "r+b") as f:
                    f.truncate(max(os.path.getsize(target) // 2, 1))
                self._log(f"truncated checkpoint file: {target} (round {rnd})")

    @staticmethod
    def _largest_data_file(path: str) -> str | None:
        best, best_size = None, -1
        for root, _, files in os.walk(path):
            for f in files:
                if f == "manifest.json":
                    continue
                full = os.path.join(root, f)
                size = os.path.getsize(full)
                if size > best_size:
                    best, best_size = full, size
        return best
