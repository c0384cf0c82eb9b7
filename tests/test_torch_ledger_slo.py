"""The port's round ledger, postmortem bundle and SLO engine
(``obs/ledger.py``, ``obs/slo.py`` and their wiring) against the JAX
package's.

- A port CLI run and a JAX CLI run of one tiny config (the both_tiny pair
  of tests/test_torch_loop_parity.py) write ledgers with the same record
  keys, cohorts equal id for id and fingerprints within relative 1e-5.
- Each package's ``replay-check`` and ``diff`` give the same exit code on
  ledgers the other wrote, clean or damaged.
- Preempt -> 75 -> resume leaves one ledger with no gaps or duplicates;
  the exit-75 postmortem bundle holds the trace, the ledger tail, the
  registry, the config and the reason.
- The SLO grammar's errors, and the same firings (rule, round) as the JAX
  engine on the same seeded series; ``--slo halt`` ends the run loop
  cleanly and ``RunStats.slo_violations`` counts episodes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cv_train as jcv
from commefficient_tpu.obs import ledger as jledger
from commefficient_tpu.obs import registry as jreg
from commefficient_tpu.obs import slo as jslo
from commefficient_tpu.obs import trace as jtrace
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch.federated.api import FedOptimizer
from commefficient_tpu_torch.obs import ledger as tledger
from commefficient_tpu_torch.obs import registry as treg
from commefficient_tpu_torch.obs import slo as tslo
from commefficient_tpu_torch.obs import trace as ttrace
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.runner import RunnerConfig, run_loop
from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults
from test_torch_loop_parity import MODES, both_tiny  # noqa: F401
from test_torch_runner import _argv, tiny_cv  # noqa: F401

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    monkeypatch.setattr(treg, "_DEFAULT", treg.Registry())
    monkeypatch.setattr(jreg, "_DEFAULT", jreg.Registry())
    yield
    ttrace.configure()
    jtrace.configure()


# ------------------------------------------------- port ledger vs JAX's


def test_cli_ledger_matches_jax(both_tiny, tmp_path):  # noqa: F811
    common = ["--dataset", "cifar10", *MODES["sketch"], "--num_clients", "8",
              "--num_workers", "2", "--local_batch_size", "4", "--lr_scale", "0.05",
              "--data_root", "/nonexistent", "--num_rounds", "4", "--eval_every", "2",
              "--health_every", "2", "--slo", "warn", "--sync_loop"]
    jl, tl = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jcv.main(common + ["--num_devices", "1", "--ledger", jl])
    tcv.main(common + ["--device", "cpu", "--ledger", tl])
    jrecs, trecs = jledger.read_records(jl), tledger.read_records(tl)
    assert jrecs[0] == trecs[0]  # the header: the same static block
    jr, tr = jrecs[1:], trecs[1:]
    assert [r["round"] for r in tr] == [r["round"] for r in jr] == [0, 1, 2, 3]
    for j, t in zip(jr, tr):
        assert sorted(t) == sorted(j), t["round"]
        assert t["cohort"] == j["cohort"]
        assert sorted(t["metrics"]) == sorted(j["metrics"])
        assert (t["health"] is None) == (j["health"] is None) == (t["round"] % 2 == 1)
        if t["health"] is not None:
            assert sorted(t["health"]) == sorted(j["health"])
        assert t["fingerprint"].keys() == j["fingerprint"].keys()
        for k, v in t["fingerprint"].items():
            np.testing.assert_allclose(v, j["fingerprint"][k], rtol=1e-5, err_msg=k)
    assert tledger.replay_check(tl) == jledger.replay_check(jl) == []


def _write_ledger(mod, path, rounds, fp=1.0, torn_middle=False):
    led = mod.RoundLedger(str(path), static={"mode": "sketch"}, registry=None)
    led.close()
    with open(path, "a") as fh:
        for i, r in enumerate(rounds):
            rec = {"schema": 1, "kind": "round", "round": r, "cohort": [r, r + 1],
                   "metrics": {"lr": 0.1}, "health": None,
                   "fingerprint": {"params_l2sq": fp * (r + 1)}}
            line = json.dumps(rec)
            if torn_middle and i == 1:
                line = line[:20]
            fh.write(line + "\n")


LEDGERS = {
    "clean": dict(rounds=[0, 1, 2, 3]),
    "gap": dict(rounds=[0, 1, 3]),
    "dup": dict(rounds=[0, 1, 1, 2]),
    "torn_middle": dict(rounds=[0, 1, 2], torn_middle=True),
}
PACKAGES = {"jax": (jledger, "commefficient_tpu.obs.ledger"),
            "torch": (tledger, "commefficient_tpu_torch.obs.ledger")}


@pytest.mark.parametrize("case", list(LEDGERS))
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_replay_check_exit_codes_agree_across_packages(tmp_path, writer, case):
    path = tmp_path / "l.jsonl"
    _write_ledger(PACKAGES[writer][0], path, **LEDGERS[case])
    codes = {name: mod.main(["replay-check", str(path)]) for name, (mod, _) in PACKAGES.items()}
    assert codes["jax"] == codes["torch"] == (0 if case == "clean" else 1)


@pytest.mark.parametrize("case", ["equal", "divergent", "missing_round"])
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_diff_exit_codes_agree_across_packages(tmp_path, writer, case):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    mod = PACKAGES[writer][0]
    _write_ledger(mod, a, [0, 1, 2])
    _write_ledger(mod, b, [0, 1, 2] if case != "missing_round" else [0, 1],
                  fp=1.0 if case != "divergent" else 1.5)
    results = {name: (m.main(["diff", str(a), str(b)]), m.diff(str(a), str(b)))
               for name, (m, _) in PACKAGES.items()}
    assert results["jax"] == results["torch"]
    assert results["torch"][0] == (0 if case == "equal" else 1)


def test_ledger_cli_module_exit_codes(tmp_path):
    """``python -m commefficient_tpu_torch.obs.ledger``: 0 clean, 1 a
    violation, 2 usage; it imports no JAX."""
    good, bad = tmp_path / "good.jsonl", tmp_path / "bad.jsonl"
    _write_ledger(tledger, good, [0, 1, 2])
    _write_ledger(tledger, bad, [0, 2])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    mod = "commefficient_tpu_torch.obs.ledger"
    for argv, code in ((["replay-check", str(good)], 0), (["replay-check", str(bad)], 1),
                       (["diff", str(good), str(good)], 0), (["diff", str(good), str(bad)], 1),
                       ([], 2), (["replay-check"], 2), (["nope", str(good)], 2)):
        proc = subprocess.run([sys.executable, "-c",
                               f"import runpy, sys; sys.argv = ['ledger'] + {argv!r}; "
                               f"runpy.run_module({mod!r}, run_name='__main__')"],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == code, (argv, proc.stdout, proc.stderr)
    proc = subprocess.run([sys.executable, "-m", mod, "replay-check", str(good)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "RuntimeWarning" not in proc.stderr, proc.stderr


def test_ledger_appends_are_strictly_monotonic(tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = tledger.RoundLedger(path, static={"merge_policy": "sum"})
    for r in range(3):
        led.append_round(r, cohort=[1, 2], metrics={"participants": 2.0, "lr": 0.1})
    with pytest.raises(tledger.LedgerError, match="out of order"):
        led.append_round(2)
    led.close()
    assert tledger.replay_check(path) == []
    with open(path, "a") as fh:  # a torn final line is the legal crash artifact
        fh.write('{"schema": 1, "kind": "round", "rou')
    assert len(tledger.read_records(path)) == 4


# ------------------------------------------------- preempt -> 75 -> resume


def test_preempt_resume_ledger_is_gap_free(tiny_cv, tmp_path):  # noqa: F811
    """One ledger file across preempt@3 -> exit 75 -> --resume: every round
    once, the fingerprints of an uninterrupted twin; the exit-75 bundle
    holds the trace, the ledger tail, the registry, the config and the
    reason."""
    led = str(tmp_path / "run.jsonl")
    base = _argv(("--num_rounds", "6", "--eval_every", "2", "--checkpoint_every", "2",
                  "--health_every", "2", "--trace", str(tmp_path / "t.json")), "sketch")
    with pytest.raises(SystemExit) as ei:
        tcv.main(base + ["--ledger", led, "--checkpoint_dir", str(tmp_path / "ck"),
                         "--fault_plan", "preempt@3"])
    assert ei.value.code == EXIT_RESUMABLE
    bundle = led + ".postmortem"
    assert sorted(os.listdir(bundle)) == ["config.json", "ledger_tail.jsonl", "reason.json",
                                         "registry.json", "trace.json"]
    reason = json.load(open(f"{bundle}/reason.json"))
    assert reason["reason"] == "preemption" and reason["artifact_failures"] is None
    trace = json.load(open(f"{bundle}/trace.json"))["traceEvents"]
    assert any(e.get("name") == "fault:preempt" for e in trace)
    tail = [json.loads(line) for line in open(f"{bundle}/ledger_tail.jsonl")]
    assert [r["round"] for r in tail if r["kind"] == "round"] == [0, 1, 2, 3]
    assert json.load(open(f"{bundle}/registry.json"))["resilience_faults_injected_total"] == 1
    assert json.load(open(f"{bundle}/config.json"))["fault_plan"] == "preempt@3"

    session = tcv.main(base + ["--ledger", led, "--checkpoint_dir", str(tmp_path / "ck"),
                               "--fault_plan", "preempt@3", "--resume"])
    assert session.round == 6
    assert tledger.replay_check(led) == [] and jledger.replay_check(led) == []
    recs = tledger.round_records(led)
    assert [r["round"] for r in recs] == list(range(6))
    # the uninterrupted twin's records, but for the injection's counter (its
    # delta lands on the first round the drain after the injection commits)
    twin = str(tmp_path / "twin.jsonl")
    tcv.main(base + ["--ledger", twin])
    first = tledger.diff(led, twin)["first_divergence"]
    assert (first["field"], first["a"], first["b"]) == (
        "counters", {"resilience_faults_injected_total": 1.0}, None)
    for r in recs:
        r.pop("counters", None)
    assert recs == tledger.round_records(twin)


def test_postmortem_bundle_contents(tiny_cv, tmp_path):  # noqa: F811
    led = str(tmp_path / "l.jsonl")
    tcv.main(_argv(("--num_rounds", "3", "--ledger", led, "--trace",
                    str(tmp_path / "t.json")), "sketch"))
    out = tledger.write_postmortem_bundle(str(tmp_path / "bundle"), reason="test",
                                          ledger_path=led, last_k=2,
                                          config={"mode": "sketch", "fn": print})
    reason = json.load(open(f"{out}/reason.json"))
    assert reason["reason"] == "test" and reason["artifact_failures"] is None
    assert "traceEvents" in json.load(open(f"{out}/trace.json"))
    tail = [json.loads(line) for line in open(f"{out}/ledger_tail.jsonl")]
    assert [r["round"] for r in tail] == [1, 2]
    assert isinstance(json.load(open(f"{out}/registry.json")), dict)
    cfg = json.load(open(f"{out}/config.json"))
    assert cfg["mode"] == "sketch" and isinstance(cfg["fn"], str)


# -------------------------------------------------------------- the SLOs


@pytest.mark.parametrize("spec", ["noop", "x:series=1", "x:series>nan@0", "x:s>1@0",
                                  "a:x>1;a:y>2", "q:quarantine rate>1"])
def test_slo_grammar_errors_equal_jax(spec):
    with pytest.raises(ValueError) as t:
        tslo.parse_rules(spec)
    with pytest.raises(ValueError) as j:
        jslo.parse_rules(spec)
    assert str(t.value) == str(j.value)


def test_slo_rules_parse_as_jax():
    for spec in ("", "q:quarantine_rate>0.3@5", "f:topk_mass_proxy<0.05;i:server_idle_ms^5@10"):
        assert [tuple(vars(r).values()) for r in tslo.parse_rules(spec)] == \
            [tuple(vars(r).values()) for r in jslo.parse_rules(spec)]
    assert tslo.DEFAULT_RULES == jslo.DEFAULT_RULES
    with pytest.raises(SystemExit, match="--slo warn"):
        resolve_defaults(make_parser().parse_args(["--slo_rules", "a:x>1"]))
    with pytest.raises(SystemExit, match="bad SLO rule"):
        resolve_defaults(make_parser().parse_args(["--slo", "warn", "--slo_rules", "nope"]))


RULES = ("spike:loss_sum>3@3;floor:topk_mass_proxy<0.3@2;reg:comm_up_mb^2@3;"
         "q:quarantine_rate>0.2@2;stale:stale_fraction>0.5@2")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["warn", "halt"])
def test_slo_firings_equal_jax(seed, mode):
    """Both engines on one seeded series (metrics, a health block on every
    other round, attack counters in each engine's own registry): the same
    events, in order, and the same halt latch and counters."""
    rng = np.random.RandomState(seed)
    engines = {}
    for name, slo, reg in (("torch", tslo, treg.Registry()), ("jax", jslo, jreg.Registry())):
        engines[name] = slo.SloEngine(slo.parse_rules(RULES), mode=mode, registry=reg,
                                      alert=lambda m: None)
    for rnd in range(40):
        metrics = {"loss_sum": float(rng.gamma(2.0, 1.5)),
                   "comm_up_mb": float(rng.choice([1.0, 1.0, 5.0])),
                   "participants": float(rng.randint(0, 8)),
                   "clients_quarantined": float(rng.randint(0, 3)),
                   "stale_folded": float(rng.randint(0, 4))}
        health = {"topk_mass_proxy": float(rng.rand())} if rnd % 2 == 0 else None
        attacks = int(rng.randint(0, 2))
        for eng in engines.values():
            eng.registry.counter("resilience_attack_signflip_total").inc(attacks)
            eng.on_round(rnd, metrics, health)
    t, j = engines["torch"], engines["jax"]
    assert t.events == j.events and t.events
    assert (t.halted, t.halted_reason) == (j.halted, j.halted_reason)
    assert t.registry.snapshot() == j.registry.snapshot()
    assert t.snapshot() == j.snapshot()


def _session(tiny_cv_args=()):
    args = resolve_defaults(make_parser().parse_args(_argv(tiny_cv_args, "sketch")))
    return tcv.build(args)[0]


def test_slo_halt_ends_the_run_loop_cleanly(tiny_cv, tmp_path, capsys):  # noqa: F811
    s = _session()
    eng = tslo.SloEngine(tslo.parse_rules("p:participants>0.5@2"), mode="halt",
                         alert=lambda m: None)
    s.slo = eng
    cfg = RunnerConfig(total_rounds=6, eval_every=6, sync_loop=True,
                       checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(SystemExit) as ei:
        run_loop(s, FedOptimizer(lambda _: LR, 1), cfg, slo=eng)
    assert "SLO violation" in str(ei.value.code) and "state checkpointed clean" in \
        str(ei.value.code)
    assert s.round == 2 and eng.halted  # halted at the drain after round 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["round_00000002"]


def test_runstats_carries_slo_violations(tiny_cv):  # noqa: F811
    s = _session()
    eng = tslo.SloEngine(tslo.parse_rules("p:participants>0.5@1"), mode="warn",
                         alert=lambda m: None)
    s.slo = eng
    stats = run_loop(s, FedOptimizer(lambda _: LR, 1),
                     RunnerConfig(total_rounds=3, eval_every=3, sync_loop=True), slo=eng)
    assert stats.rounds == 3 and stats.slo_violations == 1  # one episode, edge-triggered
    assert [e["round"] for e in eng.events] == [0]


def test_cli_slo_halt_through_the_flags(tiny_cv, tmp_path):  # noqa: F811
    """--slo halt with a health rule: the run stops at the first drain
    whose window fills, with the rule in the exit message."""
    with pytest.raises(SystemExit) as ei:
        tcv.main(_argv(("--num_rounds", "6", "--sync_loop", "--health_every", "1",
                        "--slo", "halt", "--slo_rules", "g:grad_mass_est>0@2"), "sketch"))
    assert "SLO violation (g: mean(grad_mass_est)@2" in str(ei.value.code)
