"""Declarative SLO / anomaly engine over the per-round metric series (the
port's copy of the JAX package's ``obs/slo.py``, standard library only).

The registry (obs/registry.py) holds the numbers; nothing watched them.
This module evaluates a small declarative rule set against the committed
round stream — the session calls `SloEngine.on_round` from the same
commit-boundary publish hook that feeds the health monitor and the round
ledger, so rules see every committed round exactly once, in order, with
the health block when the cadence armed it.

Rule grammar (``--slo_rules "spec;spec;..."``), one rule per spec:

    <name>:<series><op><threshold>[@<window>]

    ops:  >   windowed mean over the last `window` rounds ABOVE threshold
          <   windowed mean BELOW threshold (floors — recall, accuracy);
              evaluated only once `window` samples exist, so a cold start
              can't false-fire
          ^   regression: windowed mean above `threshold` x the mean of
              ALL OLDER samples (needs 2x window samples and a positive
              baseline — "the last 10 rounds are 5x worse than the run
              so far")

    window defaults to 5 rounds.

Series resolved per round, in precedence order: every numeric key of the
round's metrics dict; the derived rates `quarantine_rate`
(quarantined / (participants + quarantined)), `stale_fraction`
(stale_folded / (participants + stale_folded)) and `attack_rate` (the
per-round delta of the `resilience_attack_*` counter family's sum —
normride / stale_poison / signflip / scale / collude injections this
round); `server_idle_ms` read from the registry gauge the runner
publishes; and every scalar of the round's health block by its bare
estimator name (`topk_mass_proxy`, `verror_ratio`, ...) — absent on
off-cadence rounds, in which case rules over health series simply don't
accumulate that round.

The default rule set (``--slo warn|halt`` with no --slo_rules) watches
the six failure classes the ROADMAP's adaptive-compression controller
needs guarded: a quarantine-rate spike, a recall-proxy floor, a runaway
stale-fold fraction (tuned so a healthy small-buffer --serve_async run —
which legitimately folds more stale tables than it has on-time
participants — stays quiet; only a sustained near-total takeover fires),
an adversarial-injection spike over the attack counter family, a
server_idle_ms regression, and a non-finite-round streak (windowed
mean > 0.99 over 3 rounds == 3 consecutive skips).

Actions: every firing increments ``slo_violations_total`` +
``slo_rule_<name>_total`` (surfaced in /metrics and RunStats), emits a
trace instant, and warns on stderr. ``mode="halt"`` additionally latches
``halted`` — the runner checks it at the drain boundary and exits through
the same clean shutdown/save path --on_nonfinite halt uses. Firings are
edge-triggered per violation episode (ok -> violating), so a persistent
breach logs once, not once per round.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import sys

DEFAULT_RULES = (
    "quarantine_spike:quarantine_rate>0.3@5",
    "recall_floor:topk_mass_proxy<0.05@5",
    # tuned for --serve_async: a healthy buffered run at a small
    # --serve_buffer legitimately folds more stale tables than it has
    # on-time participants (trigger 2-of-8 + a full slot stack puts
    # stale_fraction well past the old 0.5), so the guard fires only on a
    # SUSTAINED near-total stale takeover — the actual runaway signature
    "stale_runaway:stale_fraction>0.85@8",
    # adversarial-injection guard over the resilience_attack_* counter
    # family (normride / stale_poison / signflip / scale / collude):
    # attack_rate is the per-round delta of the family's sum
    "attack_spike:attack_rate>0.5@3",
    "idle_regression:server_idle_ms^5@10",
    "nonfinite_streak:nonfinite_rounds>0.99@3",
)

_RULE_RE = re.compile(
    r"^(?P<name>[A-Za-z0-9_.-]+):(?P<series>[A-Za-z0-9_./-]+)"
    r"(?P<op>[><^])(?P<thr>[-+]?[0-9.]+(?:[eE][-+]?\d+)?)"
    r"(?:@(?P<win>\d+))?$")


@dataclasses.dataclass(frozen=True)
class SloRule:
    name: str
    series: str
    op: str  # ">" | "<" | "^"
    threshold: float
    window: int = 5

    @classmethod
    def parse(cls, spec: str) -> "SloRule":
        m = _RULE_RE.match(spec.strip())
        if m is None:
            raise ValueError(
                f"bad SLO rule {spec!r}: expected "
                "name:series(>|<|^)threshold[@window]")
        win = int(m.group("win") or 5)
        if win < 1:
            raise ValueError(f"bad SLO rule {spec!r}: window must be >= 1")
        return cls(name=m.group("name"), series=m.group("series"),
                   op=m.group("op"), threshold=float(m.group("thr")),
                   window=win)


def parse_rules(spec: str) -> tuple[SloRule, ...]:
    """';'-separated rule specs -> rules; empty spec -> DEFAULT_RULES.
    Validated eagerly — a typo'd rule must fail at launch, not be a
    silently-absent guard discovered at the postmortem."""
    parts = [p for p in (spec or "").split(";") if p.strip()]
    if not parts:
        parts = list(DEFAULT_RULES)
    rules = tuple(SloRule.parse(p) for p in parts)
    names = [r.name for r in rules]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate SLO rule name(s): {sorted(dupes)}")
    return rules


class SloEngine:
    """Evaluate the rule set each committed round (see module doc)."""

    def __init__(self, rules=None, mode: str = "warn", registry=None,
                 alert=None):
        if mode not in ("warn", "halt"):
            raise ValueError(f"slo mode must be 'warn' or 'halt', got "
                             f"{mode!r}")
        if rules is None:
            rules = parse_rules("")
        if registry is None:
            from . import registry as obreg

            registry = obreg.default()
        self.rules = tuple(rules)
        self.mode = mode
        self.registry = registry
        self.alert = alert or (
            lambda msg: print(msg, file=sys.stderr, flush=True))
        self.halted = False
        self.halted_reason: str | None = None
        self.events: list[dict] = []
        # per-series bounded history: 4x the largest window covers the
        # regression baseline with room, O(1) memory per series
        depth = 4 * max((r.window for r in self.rules), default=5)
        self._hist: dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=max(depth, 20)))
        self._violating: dict[str, bool] = {r.name: False for r in self.rules}
        # attack_rate baseline: the per-round delta of the
        # resilience_attack_* counter family starts at THIS engine's
        # construction, so a fresh engine never inherits a predecessor
        # run's cumulative attack count as one giant first-round spike
        self._attack_seen = self._attack_total()

    def _attack_total(self) -> float:
        """Cumulative sum over the resilience_attack_* counter family."""
        return float(sum(self.registry.counter_values(("resilience_attack_",)).values()))

    # -- series assembly -----------------------------------------------------

    def _samples(self, metrics: dict, health: dict | None) -> dict:
        s: dict[str, float] = {}
        for k, v in (metrics or {}).items():
            if isinstance(v, (int, float)):
                s[k] = float(v)
        part = s.get("participants", 0.0)
        if "clients_quarantined" in s:
            q = s["clients_quarantined"]
            s["quarantine_rate"] = q / max(part + q, 1.0)
        if "stale_folded" in s:
            f = s["stale_folded"]
            s["stale_fraction"] = f / max(part + f, 1.0)
        s.setdefault("server_idle_ms",
                     self.registry.gauge("server_idle_ms").value)
        # per-round attack injections (the resilience_attack_* family's
        # delta since the last committed round): the attack_spike rule's
        # series — counters are cumulative, rules want a rate
        total = self._attack_total()
        s["attack_rate"] = max(total - self._attack_seen, 0.0)
        self._attack_seen = total
        for k, v in (health or {}).items():
            if isinstance(v, (int, float)):
                s.setdefault(k, float(v))
        return s

    # -- evaluation ----------------------------------------------------------

    def _evaluate(self, rule: SloRule) -> tuple[bool, float | None]:
        hist = self._hist.get(rule.series)
        if not hist:
            return False, None
        vals = list(hist)
        if len(vals) < rule.window:
            return False, None
        cur = sum(vals[-rule.window:]) / rule.window
        if rule.op == ">":
            return cur > rule.threshold, cur
        if rule.op == "<":
            return cur < rule.threshold, cur
        # "^" regression: current window vs the older baseline
        base_vals = vals[:-rule.window]
        if len(base_vals) < rule.window:
            return False, cur
        base = sum(base_vals) / len(base_vals)
        if base <= 0:
            return False, cur
        return cur > rule.threshold * base, cur

    def on_round(self, rnd: int, metrics: dict,
                 health: dict | None = None) -> list[dict]:
        """Fold one committed round in and evaluate every rule; returns
        the events that FIRED this round (edge-triggered)."""
        from . import trace as obtrace

        samples = self._samples(metrics, health)
        # one append per SERIES per round (not per rule): two rules
        # watching the same series must see the same, un-duplicated
        # history or every windowed mean over it is corrupted
        for series in dict.fromkeys(r.series for r in self.rules):
            if series in samples:
                self._hist[series].append(samples[series])
        fired: list[dict] = []
        for rule in self.rules:
            violating, value = self._evaluate(rule)
            was = self._violating[rule.name]
            self._violating[rule.name] = violating
            if not violating or was:
                continue  # edge trigger: fire on ok -> violating only
            ev = {"round": rnd, "rule": rule.name, "series": rule.series,
                  "op": rule.op, "threshold": rule.threshold,
                  "window": rule.window,
                  "value": round(value, 6) if value is not None else None,
                  "action": self.mode}
            fired.append(ev)
            self.events.append(ev)
            self.registry.counter("slo_violations_total").inc()
            self.registry.counter(f"slo_rule_{rule.name}_total").inc()
            obtrace.instant("runner", f"slo:{rule.name}", **ev)
            self.alert(
                f"SLO: rule {rule.name!r} violated at round {rnd}: "
                f"mean({rule.series})@{rule.window} = {ev['value']} "
                f"{rule.op} {rule.threshold} (action: {self.mode})")
            if self.mode == "halt" and not self.halted:
                self.halted = True
                self.halted_reason = (
                    f"{rule.name}: mean({rule.series})@{rule.window} = "
                    f"{ev['value']} {rule.op} {rule.threshold}")
        return fired

    def snapshot(self) -> dict:
        """JSON-able posture block for /metrics: mode, rules, firings."""
        return {
            "mode": self.mode,
            "rules": [f"{r.name}:{r.series}{r.op}{r.threshold:g}"
                      f"@{r.window}" for r in self.rules],
            "violations": int(
                self.registry.counter("slo_violations_total").value),
            "halted": self.halted,
            "last_events": self.events[-5:],
        }
