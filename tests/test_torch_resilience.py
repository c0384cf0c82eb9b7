"""The port's fault injection and recovery (``commefficient_tpu_torch/
resilience/`` and ``utils/watchdog.py``), mirroring the parse, retry,
preemption-handler, engine-recovery and watchdog cases of
tests/test_resilience.py and tests/test_watchdog.py. Everything is seeded,
so a failure here reproduces. Same tiny-MLP CLI fixture as
tests/test_torch_runner.py."""

import os
import signal
import time

import numpy as np
import pytest
import torch

from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.resilience import (EXIT_RESUMABLE, FaultPlan,
                                                InjectedTransientError, PreemptionHandler,
                                                RetryPolicy, reset_retry_counts,
                                                retry_counts, with_retries)
from commefficient_tpu_torch.resilience import faults
from commefficient_tpu_torch.resilience.faults import ADVERSARIAL_KINDS, NOT_PORTED
from commefficient_tpu_torch.utils import checkpoint as ckpt
from commefficient_tpu_torch.utils.watchdog import RoundWatchdog
from test_torch_runner import LR, _args, _argv, _assert_state_equal, tiny_cv  # noqa: F401

# ------------------------------------------------------------- faults.py


def test_fault_plan_parse():
    plan = FaultPlan.parse("preempt@3;nonfinite@4:value=inf;data_fail@1,2:times=2;seed=9")
    assert plan.seed == 9
    assert plan.spec("preempt", 3).rounds == (3,)
    assert plan.spec("preempt", 4) is None
    assert plan.spec("nonfinite", 4).params == {"value": "inf"}
    assert plan.spec("data_fail", 2).params["times"] == 2  # coerced at parse
    assert FaultPlan.parse("ckpt_fail:times=2").spec("ckpt_fail", 7) is not None
    assert FaultPlan.parse("") is None and FaultPlan.parse(None) is None
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("explode@1")
    with pytest.raises(ValueError):
        FaultPlan.parse("stall@1:secs")
    with pytest.raises(ValueError, match="unknown param"):
        FaultPlan.parse("data_fail@1:time=5")
    with pytest.raises(ValueError, match="bad value"):
        FaultPlan.parse("data_fail@1:times=two")
    with pytest.raises(ValueError, match="bad value"):
        FaultPlan.parse("nonfinite@1:value=infinity")
    with pytest.raises(ValueError, match="bad @round"):
        FaultPlan.parse("preempt@x")


# every kind of the reference is ported (NOT_PORTED is empty): the
# mechanism is held on edge_kill, the last kind that went through it, with
# its ROADMAP item put back
@pytest.mark.parametrize("kind", sorted(set(NOT_PORTED) | {"edge_kill"}))
def test_fault_plan_refuses_kinds_the_port_has_no_site_for(kind, monkeypatch):
    """A reference kind outside the ported subset is refused by name at
    parse, with the ROADMAP item that brings it, never accepted and
    ignored; once ported, the same entry parses."""
    assert FaultPlan.parse(f"preempt@1;{kind}@2:edges=0") is not None
    monkeypatch.setitem(faults.NOT_PORTED, kind, NOT_PORTED.get(kind, "9b"))
    with pytest.raises(ValueError, match=f"fault kind '{kind}' .* is not ported.*item "
                                         f"{faults.NOT_PORTED[kind]};"):
        FaultPlan.parse(f"preempt@1;{kind}@2")


ADVERSARIAL = {
    "client_signflip": "client_signflip@1:clients=0",
    "client_scale": "client_scale@1:clients=1,factor=4",
    "client_collude": "seed=3;client_collude@1:frac=0.5",
    "client_normride": "client_normride@1:clients=0,ride=0.5",
}


@pytest.mark.parametrize("kind", ADVERSARIAL_KINDS)
def test_adversarial_kind_parses_and_fires(tiny_cv, kind):
    """Each of the four adversarial kinds parses and, through the CLI,
    fires once on the per-client-table round it forces: its attack
    counter and the run's attacks_injected read 1."""
    from commefficient_tpu_torch.obs import registry as obreg

    plan = FaultPlan.parse(ADVERSARIAL[kind])
    assert plan.has_adversarial() and plan.spec(kind, 1) is not None
    mark = obreg.default().mark()
    clip = ["--client_update_clip", "3"] if kind == "client_normride" else []
    s = cv_train.main(_argv(("--num_rounds", "2", "--sync_loop", "--fault_plan",
                             ADVERSARIAL[kind], *clip), mode="sketch"))
    assert s._table_round and s.round == 2
    assert mark.delta(f"resilience_attack_{kind[len('client_'):]}_total") == 1.0
    assert s.run_stats.attacks_injected == 1
    assert np.isfinite(s.state["params"].numpy()).all()


def test_cli_refuses_unported_fault_kind_before_any_work(tiny_cv, monkeypatch):  # noqa: F811
    """edge_kill on a flat run (no --serve_edges) can never fire: refused
    after the session is built and before any round."""
    monkeypatch.setattr(cv_train, "run_loop", lambda *a, **kw: pytest.fail("a round ran"))
    with pytest.raises(ValueError, match="edge_kill can never fire"):
        cv_train.main(["--device", "cpu", "--fault_plan", "edge_kill@0:edges=0",
                       "--data_root", "/nonexistent", "--num_rounds", "1"])


def test_fire_transient_budget_is_per_round_site():
    plan = FaultPlan.parse("data_fail@1:times=2")
    plan.fire_transient("data_fail", 0)  # not scheduled for round 0
    for _ in range(2):
        with pytest.raises(InjectedTransientError):
            plan.fire_transient("data_fail", 1)
    plan.fire_transient("data_fail", 1)  # budget spent


def test_stall_site_sleeps_once():
    plan = FaultPlan.parse("stall@0:secs=0.05")
    t0 = time.monotonic()
    plan.data_load(0)
    first = time.monotonic() - t0
    t0 = time.monotonic()
    plan.data_load(0)
    assert first >= 0.05 and time.monotonic() - t0 < 0.05


def test_eval_stall_site_sleeps_once_on_scheduled_round():
    plan = FaultPlan.parse("eval_stall@2:secs=0.05")
    t0 = time.monotonic()
    plan.eval_load(0)
    assert time.monotonic() - t0 < 0.05
    t0 = time.monotonic()
    plan.eval_load(2)
    assert time.monotonic() - t0 >= 0.05
    t0 = time.monotonic()
    plan.eval_load(2)
    assert time.monotonic() - t0 < 0.05
    assert FaultPlan.parse("stall@2:secs=9").spec("eval_stall", 2) is None


def test_poison_fills_float_leaves_and_spares_control_rows():
    plan = FaultPlan.parse("nonfinite@1:value=inf")
    batch = {"x": np.zeros((2, 3), np.float32), "y": np.zeros(2, np.int32),
             "_valid": np.ones(2, np.float32)}
    assert plan.poison(0, batch) is batch
    out = plan.poison(1, batch)
    assert np.isinf(out["x"]).all() and (out["y"] == 0).all() and (out["_valid"] == 1).all()


# -------------------------------------------------------------- retry.py


def test_retry_counts_surface_failed_attempts():
    reset_retry_counts()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flake")
        return "ok"

    with_retries(flaky, site="countme", policy=RetryPolicy(max_retries=3, base_delay_s=0.0),
                 sleep=lambda d: None, log=lambda m: None)
    assert retry_counts()["countme"] == 2
    assert "neverfailed" not in retry_counts()
    reset_retry_counts()
    assert retry_counts() == {}


def test_with_retries_recovers_then_exhausts():
    calls, logs = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient flake")
        return "ok"

    out = with_retries(flaky, site="t", policy=RetryPolicy(max_retries=3, base_delay_s=0.0),
                       sleep=lambda d: None, log=logs.append)
    assert out == "ok" and len(calls) == 3
    assert len(logs) == 2 and all("retry[t]" in line for line in logs)
    attempts = []

    def always_fails():
        attempts.append(1)
        raise OSError("permanent")

    with pytest.raises(OSError, match="permanent"):
        with_retries(always_fails, site="t", policy=RetryPolicy(max_retries=2, base_delay_s=0.0),
                     sleep=lambda d: None, log=logs.append)
    assert len(attempts) == 3


def test_retry_jitter_is_seeded():
    pol = RetryPolicy(max_retries=3, base_delay_s=0.1)
    a = [pol.delay_s(i, np.random.RandomState(5)) for i in range(3)]
    b = [pol.delay_s(i, np.random.RandomState(5)) for i in range(3)]
    assert a == b and a[1] > a[0]
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)


# --------------------------------------------------------- preemption.py


def test_preemption_handler_sets_flag_and_restores_previous():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionHandler() as pre:
            assert not pre.triggered
            os.kill(os.getpid(), signal.SIGTERM)
            assert pre.triggered  # a flag only: no exit, no exception
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert EXIT_RESUMABLE == 75


# ------------------------------------------------------- engine recovery


def test_data_load_retry_replays_identical_round(tiny_cv):
    a, _ = cv_train.build(_args())
    ma = a.run_round(LR)
    b, _ = cv_train.build(_args(("--fault_plan", "data_fail@0:times=2")))
    reset_retry_counts()
    mb = b.run_round(LR)
    assert retry_counts() == {"data_load": 2}
    assert ma == mb
    _assert_state_equal(a, b)


def test_eval_stall_fires_in_real_eval_path(tiny_cv):
    s, test_set = cv_train.build(_args(("--fault_plan", "eval_stall@1:secs=0.3")))
    ev0 = s.evaluate(test_set, 32)
    s.run_round(LR)
    t0 = time.monotonic()
    ev1 = s.evaluate(test_set, 32)
    stalled = time.monotonic() - t0
    t0 = time.monotonic()
    ev2 = s.evaluate(test_set, 32)
    assert stalled >= 0.3 and stalled - (time.monotonic() - t0) >= 0.25
    assert ev1 == ev2 and ev0.keys() == ev1.keys()


def test_nonfinite_round_skipped_keeps_state_clean(tiny_cv):
    """A NaN burst through the real gradient path is skipped like a fully
    dropped cohort: momentum decays, error feedback and params never absorb
    the poison, and the skip shows in the metrics; --on_nonfinite off lets
    it through."""
    a, _ = cv_train.build(_args())
    for _ in range(2):
        a.run_round(LR)
    b, _ = cv_train.build(_args(("--fault_plan", "nonfinite@2")))
    ms = [b.run_round(LR) for _ in range(3)]
    assert [m["nonfinite_rounds"] for m in ms] == [0.0, 0.0, 1.0]
    v1 = a.state["mode_state"]["Vvelocity"]
    v2 = b.state["mode_state"]["Vvelocity"]
    assert torch.equal(v2, 0.9 * v1)
    assert torch.equal(b.state["mode_state"]["Verror"], a.state["mode_state"]["Verror"])
    assert torch.equal(b.state["params"], a.state["params"] - torch.tensor(LR) * v2)
    assert b.run_round(LR)["nonfinite_rounds"] == 0.0
    assert torch.isfinite(b.state["params"]).all()
    c, _ = cv_train.build(_args(("--fault_plan", "nonfinite@2", "--on_nonfinite", "off")))
    for _ in range(3):
        c.run_round(LR)
    assert not torch.isfinite(c.state["params"]).all()


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_on_nonfinite_halt_exits_after_a_clean_save(tiny_cv, tmp_path, sync):
    """--on_nonfinite halt: the poisoned round is skipped, the loop drains,
    saves the clean state and exits (not resumable: status 1 with the
    reason)."""
    ckdir = str(tmp_path / "ck")
    argv = _argv(("--num_rounds", "6", "--fault_plan", "nonfinite@1", "--on_nonfinite",
                  "halt", "--checkpoint_dir", ckdir, "--max_inflight", "2",
                  *(["--sync_loop"] if sync else [])))
    with pytest.raises(SystemExit) as ei:
        cv_train.main(argv)
    assert "halting at round 2" in str(ei.value.code)
    assert "checkpointed clean" in str(ei.value.code)
    path = ckpt.latest(ckdir)
    assert path.endswith("round_00000002") and ckpt.verify(path) is True
    s, _ = cv_train.build(_args())
    ckpt.restore(path, s)
    assert torch.isfinite(s.state["params"]).all()
    assert all(torch.isfinite(v).all() for v in s.state["mode_state"].values())


def test_cli_refuses_watchdog_abort_without_checkpoint_dir():
    with pytest.raises(SystemExit, match="--watchdog_abort needs --checkpoint_dir"):
        cv_train.main(["--device", "cpu", "--watchdog_abort", "--num_rounds", "1"])


# ------------------------------------------------------------ watchdog.py


def test_unarmed_until_history():
    wd = RoundWatchdog(min_history=3)
    assert wd.threshold_s() is None
    for i in range(3):
        with wd.round(i):
            pass
    assert wd.threshold_s() is not None


def test_fast_rounds_never_alert():
    alerts = []
    wd = RoundWatchdog(factor=10.0, min_history=2, floor_s=0.5, alert=alerts.append)
    for i in range(6):
        with wd.round(i):
            time.sleep(0.01)
    assert alerts == [] and wd.stalls_detected == 0


def test_unrecorded_segments_do_not_feed_the_median():
    """The async loop's dispatches are guarded with record=False: they must
    not pull the learned median down."""
    wd = RoundWatchdog(min_history=2, floor_s=0.01)
    for i in range(2):
        with wd.round(i):
            time.sleep(0.05)
    before = wd.threshold_s()
    for i in range(2, 12):
        with wd.round(i, record=False):
            pass
    assert len(wd._times) == 2 and wd.threshold_s() == before


def test_multi_round_segment_scales_threshold_and_normalizes_median():
    alerts = []
    wd = RoundWatchdog(factor=3.0, min_history=2, floor_s=0.01, alert=alerts.append)
    for i in range(2):
        with wd.round(i):
            time.sleep(0.03)
    thr = wd.threshold_s()
    with wd.round(2, rounds=4):
        time.sleep(min(0.12, 4 * thr * 0.8))
    assert alerts == [] and wd.stalls_detected == 0
    assert wd._times[-1] < 2 * wd._times[0] + 0.05


def test_stalled_round_alerts_once_with_diagnosis():
    alerts = []
    wd = RoundWatchdog(factor=3.0, min_history=2, floor_s=0.05, alert=alerts.append)
    for i in range(3):
        with wd.round(i):
            time.sleep(0.02)
    with wd.round(99):
        time.sleep(0.4)
    assert wd.stalls_detected == 1
    assert "round 99" in alerts[0] and "hung" in alerts[0]
    with wd.round(100):
        pass
    assert wd.stalls_detected == 1


def test_floor_suppresses_early_alerts():
    alerts = []
    wd = RoundWatchdog(factor=2.0, min_history=1, floor_s=10.0, alert=alerts.append)
    with wd.round(0):
        time.sleep(0.01)
    with wd.round(1):
        time.sleep(0.1)
    assert alerts == []


def _stall_until(wd, round_index, n_stages, deadline_s=15.0):
    with wd.round(round_index):
        deadline = time.monotonic() + deadline_s
        while len(wd.stages_fired) < n_stages and time.monotonic() < deadline:
            time.sleep(0.02)


def test_escalation_ladder_fires_in_order():
    alerts, fired = [], []
    wd = RoundWatchdog(factor=2.0, min_history=2, floor_s=0.05, alert=alerts.append,
                       on_emergency=lambda: fired.append("ckpt"),
                       on_abort=lambda: fired.append("abort"))
    for i in range(2):
        with wd.round(i):
            time.sleep(0.01)
    _stall_until(wd, 99, n_stages=4)
    assert wd.stages_fired == ["warn", "stacks", "checkpoint", "abort"]
    assert fired == ["ckpt", "abort"] and wd.stalls_detected == 1
    assert "thread" in alerts[1] and "_stall_until" in alerts[1]
    n = len(wd.stages_fired)
    with wd.round(100):
        pass
    assert len(wd.stages_fired) == n


def test_ladder_without_callbacks_ends_with_diagnosis():
    alerts = []
    wd = RoundWatchdog(factor=2.0, min_history=2, floor_s=0.05, alert=alerts.append)
    for i in range(2):
        with wd.round(i):
            time.sleep(0.01)
    _stall_until(wd, 7, n_stages=4)
    assert wd.stages_fired == ["warn", "stacks", "checkpoint", "abort"]
    joined = "\n".join(alerts)
    assert "no emergency-checkpoint callback" in joined and "abort disabled" in joined


def test_emergency_checkpoint_failure_does_not_stop_ladder():
    alerts, fired = [], []

    def broken_ckpt():
        raise OSError("disk full")

    wd = RoundWatchdog(factor=2.0, min_history=2, floor_s=0.05, alert=alerts.append,
                       on_emergency=broken_ckpt, on_abort=lambda: fired.append("abort"))
    for i in range(2):
        with wd.round(i):
            time.sleep(0.01)
    _stall_until(wd, 5, n_stages=4)
    assert wd.stages_fired[-1] == "abort" and fired == ["abort"]
    assert any("emergency checkpoint failed" in a for a in alerts)


def test_watchdog_emergency_save_on_its_timer_thread(tiny_cv, tmp_path):
    """The ladder's checkpoint stage, wired to the run loop's save closure,
    saves the committed state from the timer thread while a round is in
    flight."""
    from commefficient_tpu_torch.runner import make_save_ckpt

    s, _ = cv_train.build(_args())
    s.run_round(LR)
    timings = []
    saved = []
    wd = RoundWatchdog(factor=2.0, min_history=1, floor_s=0.05,
                       on_emergency=lambda: saved.append(
                           make_save_ckpt(s, str(tmp_path / "ck"), timings)()),
                       alert=lambda m: None)
    with wd.round(0):
        time.sleep(0.01)
    infl = s.dispatch_round(s.prepare_round(), LR)
    with wd.round(1):  # stalled until the checkpoint stage has saved
        deadline = time.monotonic() + 15.0
        while not saved and time.monotonic() < deadline:
            time.sleep(0.02)
    s.commit_round(infl)
    assert saved and saved[0].endswith("round_00000001") and ckpt.verify(saved[0]) is True
    assert len(timings) == 1
