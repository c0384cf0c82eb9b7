"""Durable round ledger: one schema-versioned JSONL record per COMMITTED
round, plus the crash postmortem bundle and a diff/replay-check CLI (the
port's copy of the JAX package's ``obs/ledger.py``; both write the same
schema, so each package's CLI reads the other's files).

Why a ledger when there are checkpoints and metrics rows: checkpoints are
sparse (every --checkpoint_every rounds) and logging rows are eval-cadence
aggregates — neither answers the postmortem questions "which cohort ran
round 731, what did the quarantine eat there, and where exactly did two
runs of this config diverge?". The ledger answers all three: every
committed round appends one record carrying the invited cohort + masks,
the degradation/attack/stale-fold counters (per-round registry deltas),
the sketch-health block when the cadence armed it, and order-fixed fp
fingerprints of the committed params/optimizer tables (engine
`_ledger_fingerprints` — deterministic per program, so equal configs
produce equal sequences and `diff` names the first divergent round).

Write discipline — the TableLogger contract, machine-enforced end to end:

- the file is opened ONCE, append-mode, line-buffered; every record is a
  single whole-line write + flush, so a killed process leaves only
  complete, parseable JSON lines;
- records are appended at COMMIT and nowhere else: the one call site is
  FederatedSession._publish_round_obs, after commit_rounds published the
  rounds. Prepared-but-uncommitted rounds —
  prefetched, pipelined, rewound — can never appear, BY CONSTRUCTION: the
  committed-snapshot rewind discipline the RNG and re-queue ride extends
  to the ledger for free;
- resume continues the SAME file without duplicate or missing rounds: the
  constructor's `resume_round` truncates any records at/past the restored
  round (committed after the checkpoint being resumed from — they will be
  re-committed and re-appended) with an atomic temp+rename rewrite, then
  appends. `append_round` enforces strict round monotonicity, loudly.

CLI (standard library only):

    python -m commefficient_tpu_torch.obs.ledger replay-check RUN.jsonl
    python -m commefficient_tpu_torch.obs.ledger diff A.jsonl B.jsonl

`replay-check` validates schema, parseability, and gap-free strictly-
increasing rounds; `diff` compares two runs round-by-round (fingerprints
first, then counters/metrics) and reports the first divergence. Exit 0 =
clean/equal, 1 = violation/divergence, 2 = usage/IO error.

The postmortem bundle (`write_postmortem_bundle`) is the black-box
recorder's crash dump: on watchdog abort, unhandled exception, or the
preemption exit-75 path the CLIs (via runner.run_loop's `postmortem`
hook) flush ONE directory holding the Chrome trace (flushed from the live
tracer buffer even when --trace wasn't set), the last-K ledger rows, the
full registry snapshot, the resolved config, and the reason — everything
a postmortem needs, co-located, even when the process dies by os._exit.
"""

from __future__ import annotations

import json
import os
import sys
import time

LEDGER_SCHEMA_VERSION = 1

# metric keys a round record carries verbatim (when present): the
# degradation/round-shape facts `diff` and postmortems read. Everything
# else in the metrics dict is a training aggregate the logging rows
# already carry at eval cadence.
METRIC_KEYS = (
    "lr", "participants", "clients_dropped", "clients_quarantined",
    "nonfinite_rounds", "requeue_depth", "stale_folded", "stale_weight",
    "comm_up_mb", "comm_total_mb", "loss_sum", "count",
)

# registry counter-name prefixes whose PER-ROUND deltas each record
# carries — admission decisions, wire rejections, overload sheds, stale
# folds, Byzantine attack firings, SLO violations
COUNTER_PREFIXES = (
    "serve_admission_", "serve_rejected_", "serve_shed", "serve_stale_",
    "resilience_attack_", "resilience_faults_", "slo_",
)


class LedgerError(Exception):
    """A ledger contract violation (non-monotonic append, unreadable
    resume target) — loud, never swallowed."""


class RoundLedger:
    """Append-only writer for one run's round ledger (see module doc).

    `static` is the run-shape block stamped into the header record (merge
    policy, quarantine scope, sketch geometry, cohort size — whatever the
    caller resolves from its config); `resume_round` arms the resume
    truncation; `registry` supplies the per-round counter deltas (defaults
    to the process-wide obs registry; None disables the counters block)."""

    def __init__(self, path: str, *, resume_round: int | None = None,
                 static: dict | None = None, registry=None):
        self.path = path
        self.last_round: int | None = None
        self.rounds_written = 0
        if registry is None:
            from . import registry as obreg

            registry = obreg.default()
        self._registry = registry
        self._counter_prev = self._counter_values()
        if resume_round is not None and os.path.exists(path):
            self._truncate_for_resume(resume_round)
        # opened once, line-buffered: every append is one whole-line write
        # + flush (the TableLogger crash-safety discipline)
        self._fh = open(path, "a", buffering=1)
        header = {
            "schema": LEDGER_SCHEMA_VERSION, "kind": "header",
            "resume_round": resume_round, "static": static or {},
        }
        self._fh.write(json.dumps(header) + "\n")
        self._fh.flush()

    # -- write path ----------------------------------------------------------

    def append_round(self, rnd: int, *, cohort=None, metrics=None,
                     health=None, fingerprint=None) -> None:
        """Append one committed round (from the session's commit hook,
        ``FederatedSession._publish_round_obs``, and nowhere else)."""
        if self._fh is None:
            return
        rnd = int(rnd)
        if self.last_round is not None and rnd <= self.last_round:
            raise LedgerError(
                f"ledger append out of order: round {rnd} after "
                f"{self.last_round} — rounds commit (and ledger) strictly "
                "in order; a duplicate append means a commit-path bug")
        rec: dict = {
            "schema": LEDGER_SCHEMA_VERSION, "kind": "round", "round": rnd,
        }
        if cohort is not None:
            rec["cohort"] = [int(c) for c in cohort]
        if metrics:
            rec["metrics"] = {k: float(metrics[k]) for k in METRIC_KEYS
                              if k in metrics}
        counters = self._counter_deltas()
        if counters:
            rec["counters"] = counters
        rec["health"] = health if health else None
        if fingerprint:
            # repr-exact floats: two bit-identical runs serialize
            # bit-identical fingerprint sequences (json floats round-trip)
            rec["fingerprint"] = {k: float(v) for k, v in
                                  fingerprint.items()}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self.last_round = rnd
        self.rounds_written += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- internals -----------------------------------------------------------

    def _counter_values(self) -> dict[str, float]:
        if self._registry is None:
            return {}
        return self._registry.counter_values(COUNTER_PREFIXES)

    def _counter_deltas(self) -> dict[str, float]:
        cur = self._counter_values()
        out = {}
        for k, v in cur.items():
            d = v - self._counter_prev.get(k, 0.0)
            if d:
                out[k] = d
        self._counter_prev = cur
        return out

    def _truncate_for_resume(self, resume_round: int) -> None:
        """Drop records at/past the restored round with an atomic rewrite:
        they committed after the checkpoint being resumed from, will be
        re-committed by the resumed run, and keeping them would duplicate
        exactly the rounds the resume discipline promises appear once."""
        kept: list[str] = []
        last: int | None = None
        try:
            with open(self.path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn final line from a kill: drop it
                    if (rec.get("kind") == "round"
                            and int(rec.get("round", -1)) >= resume_round):
                        continue
                    if rec.get("kind") == "round":
                        last = int(rec["round"])
                    kept.append(line)
        except OSError as e:
            raise LedgerError(
                f"cannot read ledger {self.path} for resume: {e}") from e
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write("".join(ln + "\n" for ln in kept))
        os.replace(tmp, self.path)
        self.last_round = last


# ------------------------------------------------------------- read/verify


def read_records(path: str) -> list[dict]:
    """Every parseable record in file order (headers included). A torn
    final line — the legal crash artifact — is skipped; a torn line
    ANYWHERE else is a whole-lines-contract violation and raises."""
    out: list[dict] = []
    torn_at: int | None = None
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            if torn_at is not None:
                raise LedgerError(
                    f"{path}:{torn_at + 1}: torn JSON line followed by more "
                    "data — the whole-line write discipline was violated")
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                torn_at = i
    return out


def round_records(path: str) -> list[dict]:
    return [r for r in read_records(path) if r.get("kind") == "round"]


def replay_check(path: str) -> list[str]:
    """Validate one ledger file; returns a list of problems (empty =
    clean): unknown schema, non-monotonic or gapped rounds, duplicate
    rounds, non-finite fingerprints."""
    problems: list[str] = []
    try:
        recs = read_records(path)
    except (OSError, LedgerError) as e:
        return [str(e)]
    rounds = [r for r in recs if r.get("kind") == "round"]
    if not rounds:
        problems.append("no round records")
    prev = None
    for r in rounds:
        if r.get("schema") != LEDGER_SCHEMA_VERSION:
            problems.append(
                f"round {r.get('round')}: unknown schema {r.get('schema')}")
        rnd = r.get("round")
        if not isinstance(rnd, int):
            problems.append(f"record without integer round: {r}")
            continue
        if prev is not None:
            if rnd == prev:
                problems.append(f"duplicate round {rnd}")
            elif rnd < prev:
                problems.append(f"round {rnd} after {prev} (out of order)")
            elif rnd != prev + 1:
                problems.append(
                    f"gap: round {prev} -> {rnd} "
                    f"({rnd - prev - 1} missing)")
        prev = rnd
        for k, v in (r.get("fingerprint") or {}).items():
            if v != v or v in (float("inf"), float("-inf")):
                problems.append(f"round {rnd}: non-finite fingerprint {k}")
    return problems


def diff(path_a: str, path_b: str) -> dict:
    """Round-by-round comparison of two runs: fingerprints first (the
    bit-level divergence signal), then counters and metrics. Returns
    {"equal": bool, "rounds_compared": n, "first_divergence": {...}|None,
    "only_in_a"/"only_in_b": [...]} — the CLI prints it."""
    a = {r["round"]: r for r in round_records(path_a)}
    b = {r["round"]: r for r in round_records(path_b)}
    shared = sorted(set(a) & set(b))
    first = None
    for rnd in shared:
        ra, rb = a[rnd], b[rnd]
        for field in ("fingerprint", "counters", "metrics", "cohort",
                      "health"):
            va, vb = ra.get(field), rb.get(field)
            if va != vb:
                first = {"round": rnd, "field": field, "a": va, "b": vb}
                break
        if first is not None:
            break
    return {
        "equal": first is None and set(a) == set(b),
        "rounds_compared": len(shared),
        "first_divergence": first,
        "only_in_a": sorted(set(a) - set(b)),
        "only_in_b": sorted(set(b) - set(a)),
    }


# ------------------------------------------------------- postmortem bundle


def write_postmortem_bundle(out_dir: str, *, reason: str,
                            ledger_path: str | None = None,
                            last_k: int = 50,
                            config: dict | None = None,
                            registry=None) -> str:
    """Flush the black-box state into ONE directory (see module doc):
    reason.json, trace.json (the live tracer buffer — flushed here even if
    --trace never armed a file), ledger_tail.jsonl (last-K rows),
    registry.json (full metric snapshot), config.json (resolved flags).
    Best-effort per artifact: a failing piece is noted in reason.json
    rather than aborting the rest — this runs on crash paths."""
    os.makedirs(out_dir, exist_ok=True)
    failures: dict[str, str] = {}

    from . import trace as obtrace
    from . import export as obexport
    from . import registry as obreg

    try:
        # atomic snapshot under the tracer lock (this can run on the
        # watchdog thread while the main thread is mid-span)
        events, tracks, dropped = obtrace.get().export_snapshot()
        obexport.write_chrome_trace(
            os.path.join(out_dir, "trace.json"), events, tracks,
            dropped=dropped)
    except Exception as e:  # noqa: BLE001 — crash path, collect and go on
        failures["trace"] = f"{type(e).__name__}: {e}"
    if ledger_path:
        try:
            with open(ledger_path) as fh:
                tail = fh.readlines()[-last_k:]
            with open(os.path.join(out_dir, "ledger_tail.jsonl"), "w") as fh:
                fh.write("".join(tail))
        except Exception as e:  # noqa: BLE001
            failures["ledger_tail"] = f"{type(e).__name__}: {e}"
    reg = registry if registry is not None else obreg.default()
    try:
        with open(os.path.join(out_dir, "registry.json"), "w") as fh:
            json.dump(reg.snapshot(), fh, indent=1)
    except Exception as e:  # noqa: BLE001
        failures["registry"] = f"{type(e).__name__}: {e}"
    if config is not None:
        try:
            with open(os.path.join(out_dir, "config.json"), "w") as fh:
                json.dump({k: v if isinstance(
                    v, (str, int, float, bool, type(None), list, dict))
                    else repr(v) for k, v in config.items()}, fh, indent=1)
        except Exception as e:  # noqa: BLE001
            failures["config"] = f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, "reason.json"), "w") as fh:
        json.dump({
            "schema": LEDGER_SCHEMA_VERSION, "reason": reason,
            "written_unix": time.time(),
            "artifact_failures": failures or None,
        }, fh, indent=1)
    print(f"postmortem: bundle written to {out_dir} (reason: {reason})",
          file=sys.stderr, flush=True)
    return out_dir


# ------------------------------------------------------------------- CLI


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m commefficient_tpu_torch.obs.ledger "
             "replay-check PATH | diff A B")
    if not argv:
        print(usage, file=sys.stderr)
        return 2
    cmd, args = argv[0], argv[1:]
    try:
        if cmd == "replay-check":
            if len(args) != 1:
                print(usage, file=sys.stderr)
                return 2
            problems = replay_check(args[0])
            n = len(round_records(args[0])) if not problems else 0
            if problems:
                for p in problems:
                    print(f"FAIL: {p}")
                return 1
            print(f"OK: {args[0]} — {n} rounds, gap-free, schema "
                  f"{LEDGER_SCHEMA_VERSION}")
            return 0
        if cmd == "diff":
            if len(args) != 2:
                print(usage, file=sys.stderr)
                return 2
            res = diff(args[0], args[1])
            print(json.dumps(res, indent=1))
            return 0 if res["equal"] else 1
        print(usage, file=sys.stderr)
        return 2
    except (OSError, LedgerError, KeyError, ValueError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
