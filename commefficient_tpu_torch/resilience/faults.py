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
    client_drop@2:clients=0+3   kill cohort positions 0 and 3 inside round 2:
                                their batch rows zero, their validity mask
                                goes 0 (the engine treats them as masked
                                clients), and the session re-queues their
                                client ids for a later round
    client_straggle@2:clients=1,secs=0.5
                                position 1's batch assembly stalls 0.5 s in
                                round 2 (a slow client; the round still
                                completes)
    client_poison@2:clients=1,value=big
                                fill position 1's batch rows so its update
                                goes large (value=big, finite) or
                                non-finite (nan/inf) through the real
                                gradient path
    wire_corrupt@2:clients=0    flip a byte of position 0's payload frame at
                                the serving transport seam in round 2 (the
                                checksum rejects it MALFORMED); likewise
                                wire_truncate (cut the frame short: the
                                length prefix rejects it), wire_dup (an
                                at-least-once double send: counted once),
                                conn_drop (the connection dies mid-send: a
                                no-show) and wire_delay@2:clients=1,secs=S
                                (a late frame, for the straggler
                                discipline). Payload serving only
                                (--serve_payload sketch)
    seed=7                      recorded on the plan for reporting

Round numbers are global round indices (session.round), so a plan replays
correctly across checkpoint resume: ``preempt@3`` does not fire again in a
resumed run that starts at round 4. ``FaultPlan.parse("")`` is None: no
plan, no change.

The reference's other kinds (Byzantine clients, distributed bootstrap and
one-host preemption, edge and shard kills) need sites the port does not
have yet. They are refused at parse with a message that
names them and the ROADMAP item that brings them, never accepted and
ignored.
"""

from __future__ import annotations

import base64
import dataclasses
import os
import signal
import sys
import time

import numpy as np

from ..obs import registry as obreg
from ..obs import trace as obtrace

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
    # cohort sites: target cohort positions 0..W-1, "+"-separated (","
    # separates params)
    "client_drop": ("clients",),
    "client_straggle": ("clients", "secs"),
    "client_poison": ("clients", "value"),
    # transport-seam sites of the payload round: damage a client's frame
    # between its table compute and the server's ingest
    "wire_corrupt": ("clients",),
    "wire_truncate": ("clients",),
    "wire_dup": ("clients",),
    "wire_delay": ("clients", "secs"),
    "conn_drop": ("clients",),
}

# the client_* sites fire inside a round's preparation: scheduled at or past
# the run's last round they would never inject, so validate_rounds rejects
# them at launch (the run length is not known at parse time)
CLIENT_KINDS = ("client_drop", "client_straggle", "client_poison")
# the wire_* sites fire at the serving transport seam as a round's payloads
# ship; the same schedule validation as the client kinds
WIRE_KINDS = ("wire_corrupt", "wire_truncate", "wire_dup", "wire_delay", "conn_drop")

# the reference's kinds whose sites the port does not have yet, with the
# ROADMAP Queue 1 item that brings each
NOT_PORTED = {
    "dist_init": 7, "host_preempt": 7, "edge_kill": "9b", "shard_kill": "9b",
    "client_signflip": 10, "client_scale": 10, "client_collude": 10,
    "client_normride": 10, "client_stale_poison": 10,
}


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
            f"port has no site for it yet (ROADMAP Queue 1 item {NOT_PORTED[kind]}; it "
            f"runs: {', '.join(KINDS)})")
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
                elif k == "clients":
                    pos = tuple(int(p) for p in v.split("+") if p.strip())
                    if not pos or any(p < 0 for p in pos):
                        raise ValueError("expected '+'-separated non-negative positions")
                    params[k] = pos
                elif k == "value":
                    allowed = ("nan", "inf", "big") if kind == "client_poison" else ("nan", "inf")
                    if v not in allowed:
                        raise ValueError(f"expected one of {'/'.join(allowed)}")
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

    def specs_for(self, kind: str, rnd: int | None = None) -> list[FaultSpec]:
        """Every matching spec (a client_* site may have several entries in
        one round, e.g. one drop list and one poison list)."""
        return [s for s in self.specs if s.kind == kind and s.matches(rnd)]

    def validate_rounds(self, total_rounds: int) -> None:
        """Launch-time check against the run's length: a client_* or
        wire_* site scheduled at a round >= total_rounds can never fire, and
        is refused rather than let a chaos run pass without its fault."""
        for s in self.specs:
            if s.kind in CLIENT_KINDS + WIRE_KINDS and s.rounds:
                dead = [r for r in s.rounds if r >= total_rounds]
                if dead:
                    raise ValueError(
                        f"--fault_plan: {s.kind}@{','.join(map(str, dead))} can never fire "
                        f"- the run ends at round {total_rounds} (rounds are 0-based global "
                        "indices)")

    def validate_wire_context(self, payload_path_armed: bool) -> None:
        """Launch-time check of the wire_* kinds: they damage payload
        frames at the serving transport seam, which only a served payload
        run has; on any other run they would inject nothing."""
        if payload_path_armed:
            return
        dead = sorted({s.kind for s in self.specs if s.kind in WIRE_KINDS})
        if dead:
            raise ValueError(
                f"--fault_plan: {', '.join(dead)} can never fire: the wire kinds damage "
                "payload frames at the serving transport seam and need --serve inproc|socket "
                "with --serve_payload sketch; on this run the chaos plan would pass vacuously")

    def _log(self, msg: str):
        print(f"fault-injection: {msg}", file=sys.stderr, flush=True)

    @staticmethod
    def _mark(kind: str, rnd, **args):
        """Every injection lands as a ``fault:<kind>`` trace instant on the
        resilience track, with its round, and bumps the registry's
        injected-faults counter."""
        obreg.default().counter("resilience_faults_injected_total").inc()
        obtrace.instant("resilience", f"fault:{kind}",
                        round=rnd if rnd is None else int(rnd), **args)

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
            self._mark(kind, rnd, attempt=n + 1, times=times)
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
            self._mark("stall", rnd, secs=secs)
            time.sleep(secs)
        self.fire_transient("data_fail", rnd)

    def eval_load(self, rnd: int):
        """Eval-loader site: a scheduled eval_stall sleeps once per round as
        the eval pass starts."""
        s = self._once("eval_stall", rnd)
        if s is not None:
            secs = float(s.params.get("secs", 1.0))
            self._log(f"stalling eval load {secs}s (round {rnd})")
            self._mark("eval_stall", rnd, secs=secs)
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
        poisoned = sum(1 for k, v in batch.items()
                       if not k.startswith("_") and np.issubdtype(v.dtype, np.floating))
        if poisoned:
            self._mark("nonfinite", rnd, leaves=poisoned)
        return out

    @staticmethod
    def _positions(s: FaultSpec, num_workers: int, rnd: int) -> tuple:
        pos = s.params.get("clients", (0,))
        bad = [p for p in pos if not 0 <= p < num_workers]
        if bad:
            raise ValueError(f"fault {s.kind}@{rnd}: cohort positions {bad} out of range for "
                             f"num_workers={num_workers}")
        return pos

    def client_faults(self, rnd: int, batch: dict, valid, num_workers: int):
        """Cohort faults inside round ``rnd``'s preparation, after the batch
        is assembled: client_straggle sleeps, client_poison fills the
        positions' float rows (nan/inf: a non-finite update; big: 1e6, a
        large finite one), client_drop zeroes the positions' rows and their
        validity. Returns (batch, valid, dropped positions); ``valid`` stays
        None when nothing dropped. Each fires once per (kind, round,
        positions); keys starting with "_" are control rows and stay."""
        for s in self.specs_for("client_straggle", rnd):
            key = ("client_straggle", rnd, s.params.get("clients", (0,)))
            if key in self._fired:
                continue
            self._fired.add(key)
            pos = self._positions(s, num_workers, rnd)
            secs = float(s.params.get("secs", 1.0))
            self._log(f"clients {list(pos)} straggling {secs}s (round {rnd})")
            self._mark("client_straggle", rnd, clients=list(pos), secs=secs)
            time.sleep(secs)

        poison_specs = self.specs_for("client_poison", rnd)
        drop_specs = self.specs_for("client_drop", rnd)
        if not poison_specs and not drop_specs:
            return batch, valid, []
        batch = {k: (v if k.startswith("_") else np.array(v, copy=True))
                 for k, v in batch.items()}
        for s in poison_specs:
            key = ("client_poison", rnd, s.params.get("clients", (0,)))
            if key in self._fired:
                continue
            self._fired.add(key)
            pos = list(self._positions(s, num_workers, rnd))
            val = s.params.get("value", "nan")
            fill = {"nan": np.nan, "inf": np.inf, "big": 1e6}[val]
            for k, v in batch.items():
                if not k.startswith("_") and np.issubdtype(v.dtype, np.floating):
                    v[pos] = fill
            self._log(f"poisoning clients {pos} with {val} (round {rnd})")
            self._mark("client_poison", rnd, clients=pos, value=val)
        dropped: list[int] = []
        for s in drop_specs:
            key = ("client_drop", rnd, s.params.get("clients", (0,)))
            if key in self._fired:
                continue
            self._fired.add(key)
            pos = list(self._positions(s, num_workers, rnd))
            valid = (np.ones(num_workers, np.float32) if valid is None
                     else np.array(valid, copy=True))
            for k, v in batch.items():
                if not k.startswith("_"):
                    v[pos] = 0
            valid[pos] = 0.0
            dropped.extend(pos)
            self._log(f"dropping clients {pos} (round {rnd}; masked + re-queued)")
            self._mark("client_drop", rnd, clients=pos)
        return batch, valid, dropped

    def wire_plan(self, rnd: int, num_workers: int) -> dict[int, dict]:
        """Per-position wire damage of round ``rnd``'s payload shipments,
        applied by the traffic at the transport seam: {position:
        {"corrupt", "truncate", "dup", "drop": bool, "delay_s": float}}.
        One-shot per (kind, round, positions), like the cohort sites."""
        plan: dict[int, dict] = {}

        def slot(p: int) -> dict:
            return plan.setdefault(int(p), {"corrupt": False, "truncate": False, "dup": False,
                                            "delay_s": 0.0, "drop": False})

        for kind, field in (("wire_corrupt", "corrupt"), ("wire_truncate", "truncate"),
                            ("wire_dup", "dup"), ("conn_drop", "drop")):
            for s in self.specs_for(kind, rnd):
                key = (kind, rnd, s.params.get("clients", (0,)))
                if key in self._fired:
                    continue
                self._fired.add(key)
                pos = list(self._positions(s, num_workers, rnd))
                for p in pos:
                    slot(p)[field] = True
                self._log(f"{kind} on cohort positions {pos} (round {rnd})")
                self._mark(kind, rnd, clients=pos)
        for s in self.specs_for("wire_delay", rnd):
            key = ("wire_delay", rnd, s.params.get("clients", (0,)))
            if key in self._fired:
                continue
            self._fired.add(key)
            pos = list(self._positions(s, num_workers, rnd))
            secs = float(s.params.get("secs", 1.0))
            for p in pos:
                slot(p)["delay_s"] += secs
            self._log(f"wire_delay {secs}s on cohort positions {pos} (round {rnd})")
            self._mark("wire_delay", rnd, clients=pos, secs=secs)
        return plan

    @staticmethod
    def corrupt_frame(frame: dict) -> dict:
        """One flipped payload byte (the middle one), the checksum left
        stale: the validation must reject it MALFORMED."""
        raw = bytearray(base64.b64decode(frame["data"]))
        if raw:
            raw[len(raw) // 2] ^= 0xFF
        return {**frame, "data": base64.b64encode(bytes(raw)).decode("ascii")}

    @staticmethod
    def truncate_frame(frame: dict) -> dict:
        """The frame's data cut to half with the length prefix intact: the
        decoded-length check must reject it MALFORMED."""
        raw = base64.b64decode(frame["data"])
        return {**frame, "data": base64.b64encode(raw[:len(raw) // 2]).decode("ascii")}

    def preempt(self, rnd: int):
        """Simulated preemption: deliver a real SIGTERM to this process as
        the scheduled round dispatches (one-shot)."""
        if self._once("preempt", rnd) is not None:
            self._log(f"injecting SIGTERM (preempt, round {rnd})")
            self._mark("preempt", rnd)
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
            self._mark(kind, rnd)

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
