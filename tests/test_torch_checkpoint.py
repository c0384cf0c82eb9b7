"""The port's checkpoints (``commefficient_tpu_torch/utils/checkpoint.py``),
mirroring tests/test_checkpoint.py and the checkpoint cases of
tests/test_resilience.py: a restored session continues bitwise like the
uninterrupted run; the manifest, read-back, rename-aside, fallback past
damaged checkpoints and their garbage collection behave as the
reference's. Same tiny-MLP CLI fixture as tests/test_torch_runner.py."""

import json
import os

import pytest
import torch

from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.resilience import (FaultPlan, InjectedTransientError,
                                                RetryPolicy)
from commefficient_tpu_torch.utils import checkpoint as ckpt
from test_torch_runner import LR, _args, _assert_state_equal, tiny_cv  # noqa: F401


def _run(session, n):
    for _ in range(n):
        session.run_round(LR)


def _truncate(path):
    t = FaultPlan._largest_data_file(path)
    with open(t, "r+b") as f:
        f.truncate(os.path.getsize(t) // 2)


def _flip(path):
    t = FaultPlan._largest_data_file(path)
    with open(t, "r+b") as f:
        f.seek(os.path.getsize(t) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("mode", ["uncompressed", "sketch"])
def test_save_restore_resume_equivalence(tiny_cv, tmp_path, mode):
    """6 uninterrupted rounds == 3 rounds, save, restore into a fresh
    session, 3 more: params, Vvelocity/Verror, round, comm total and the
    next cohort, bitwise."""
    sa, _ = cv_train.build(_args(mode=mode))
    _run(sa, 6)
    sb, _ = cv_train.build(_args(mode=mode))
    _run(sb, 3)
    path = ckpt.save(str(tmp_path / "ck"), sb)
    sc, _ = cv_train.build(_args(mode=mode))
    ckpt.restore(path, sc)
    assert sc.round == 3 and sc.comm_mb_total == sb.comm_mb_total
    _run(sc, 3)
    _assert_state_equal(sa, sc)
    assert sa.comm_mb_total == sc.comm_mb_total
    assert (sa.sample_cohort(6) == sc.sample_cohort(6)).all()


def test_checkpoint_is_weights_only_loadable_with_plain_json_rng(tiny_cv, tmp_path):
    """state.pt loads under torch.load's weights_only default, and the host
    RNG sits in meta.json as plain ints and lists."""
    s, _ = cv_train.build(_args())
    _run(s, 1)
    path = ckpt.save(str(tmp_path / "ck"), s)
    payload = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    assert torch.equal(payload["params"], s.state["params"])
    with open(os.path.join(path, ckpt.META_FILE)) as f:
        meta = json.load(f)
    assert meta["round"] == 1 and len(meta["host_rng"][1]) == 624
    assert sorted(os.listdir(path)) == [ckpt.MANIFEST, ckpt.META_FILE, ckpt.STATE_FILE]


def test_save_mid_flight_writes_the_committed_round(tiny_cv, tmp_path):
    """A save while a round is dispatched but not committed (the watchdog's
    emergency save) writes the committed round with its RNG snapshot, so the
    resumed run replays the in-flight round bitwise."""
    sa, _ = cv_train.build(_args())
    _run(sa, 3)
    s, _ = cv_train.build(_args())
    _run(s, 2)
    infl = s.dispatch_round(s.prepare_round(), LR)
    path = ckpt.save(str(tmp_path / "ck"), s)
    s.commit_round(infl)
    assert path.endswith("round_00000002")
    sc, _ = cv_train.build(_args())
    ckpt.restore(path, sc)
    _run(sc, 1)
    _assert_state_equal(sa, sc)


def test_restore_refuses_rounds_in_flight(tiny_cv, tmp_path):
    s, _ = cv_train.build(_args())
    _run(s, 1)
    path = ckpt.save(str(tmp_path / "ck"), s)
    s.dispatch_round(s.prepare_round(), LR)
    with pytest.raises(RuntimeError, match="in flight"):
        ckpt.restore(path, s)


def test_cohort_size_change_across_checkpoint_warns(tiny_cv, tmp_path, capsys):
    s, _ = cv_train.build(_args())
    _run(s, 1)
    path = ckpt.save(str(tmp_path / "ck"), s)
    s2, _ = cv_train.build(_args(("--num_workers", "4")))
    capsys.readouterr()
    ckpt.restore(path, s2)
    assert "will NOT replay" in capsys.readouterr().out
    s3, _ = cv_train.build(_args())
    capsys.readouterr()
    ckpt.restore(path, s3)
    assert "will NOT replay" not in capsys.readouterr().out


def test_latest_and_prune(tiny_cv, tmp_path):
    s, _ = cv_train.build(_args())
    for _ in range(5):
        _run(s, 1)
        ckpt.save(str(tmp_path / "ck"), s, keep=2)
    remaining = sorted(os.listdir(tmp_path / "ck"))
    assert remaining == ["round_00000004", "round_00000005"]
    assert ckpt.latest(str(tmp_path / "ck")).endswith(remaining[-1])
    assert ckpt.latest(str(tmp_path / "none")) is None


def test_restore_via_relative_checkpoint_dir(tiny_cv, tmp_path, monkeypatch):
    s, _ = cv_train.build(_args())
    _run(s, 2)
    monkeypatch.chdir(tmp_path)
    ckpt.save("ck_rel", s)
    path = ckpt.latest("ck_rel")
    assert os.path.isabs(path), path
    s2, _ = cv_train.build(_args())
    ckpt.restore(path, s2)
    assert s2.round == s.round == s2.state["round"]
    _assert_state_equal(s, s2)


def test_save_readback_catches_silent_bitrot(tiny_cv, tmp_path, monkeypatch):
    """Media that acknowledge a write and store other bytes fail the save
    (counted, retried); persistent bitrot exhausts the retries; a corrupt
    re-save of a saved round puts the verified copy back."""
    s, _ = cv_train.build(_args())
    _run(s, 1)
    real_manifest = ckpt._write_manifest
    lies = {"left": 1}

    def lying_media(path):
        real_manifest(path)
        if lies["left"] > 0:
            lies["left"] -= 1
            _flip(path)

    monkeypatch.setattr(ckpt, "_write_manifest", lying_media)
    before = ckpt.save_verify_failures()
    path = ckpt.save(str(tmp_path / "ck"), s,
                     retry_policy=RetryPolicy(max_retries=2, base_delay_s=0.001))
    assert ckpt.save_verify_failures() == before + 1
    assert ckpt.verify(path) is True

    lies["left"] = 99
    with pytest.raises(ckpt.CheckpointVerifyError):
        ckpt.save(str(tmp_path / "ck2"), s,
                  retry_policy=RetryPolicy(max_retries=1, base_delay_s=0.001))
    assert ckpt.save_verify_failures() == before + 3

    with pytest.raises(ckpt.CheckpointVerifyError):
        ckpt.save(str(tmp_path / "ck"), s, retry_policy=RetryPolicy(max_retries=0))
    assert ckpt.verify(path) is True

    lies["left"] = 1
    p3 = ckpt.save(str(tmp_path / "ck3"), s, retry_policy=RetryPolicy(max_retries=0),
                   verify_on_save=False)
    assert ckpt.verify(p3) is False


def test_checkpoint_write_retries_recover(tiny_cv, tmp_path):
    s, _ = cv_train.build(_args())
    _run(s, 1)
    path = ckpt.save(str(tmp_path / "ck"), s, fault_plan=FaultPlan.parse("ckpt_fail@1:times=2"),
                     retry_policy=RetryPolicy(max_retries=3, base_delay_s=0.001))
    assert ckpt.verify(path) is True
    with pytest.raises(InjectedTransientError):
        ckpt.save(str(tmp_path / "ck2"), s, fault_plan=FaultPlan.parse("ckpt_fail@1:times=5"),
                  retry_policy=RetryPolicy(max_retries=1, base_delay_s=0.001))
    ck2 = tmp_path / "ck2"
    assert not ck2.is_dir() or not any(d.startswith("round_") for d in os.listdir(ck2))


def test_same_round_resave_overwrites_cleanly(tiny_cv, tmp_path):
    """A second save of the same round replaces it through rename-aside;
    in the crash window between the renames only the displaced copy
    exists, and restore_latest recovers the round from it."""
    s, _ = cv_train.build(_args())
    _run(s, 1)
    ckdir = str(tmp_path / "ck")
    p1 = ckpt.save(ckdir, s)
    p2 = ckpt.save(ckdir, s)
    assert p1 == p2 and ckpt.verify(p2) is True
    assert not [d for d in os.listdir(ckdir) if d.endswith(".displaced")]
    os.rename(p2, p2 + ".displaced")
    s2, _ = cv_train.build(_args())
    restored = ckpt.restore_latest(ckdir, s2)
    assert restored.endswith(".displaced") and s2.round == 1


def test_corrupt_and_truncated_checkpoints_fall_back(tiny_cv, tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    s, _ = cv_train.build(_args())
    for _ in range(3):
        _run(s, 1)
        ckpt.save(ckdir, s)
    names = sorted(d for d in os.listdir(ckdir) if d.startswith("round_"))
    _truncate(os.path.join(ckdir, names[-1]))
    _flip(os.path.join(ckdir, names[-2]))
    s2, _ = cv_train.build(_args())
    restored = ckpt.restore_latest(ckdir, s2)
    err = capsys.readouterr().err
    assert restored.endswith(names[0]) and s2.round == 1
    assert err.count("FAILED integrity") == 2
    assert "recovered" in err and "skipping 2 damaged" in err


def test_fault_plan_damages_committed_checkpoint(tiny_cv, tmp_path):
    """ckpt_corrupt / ckpt_partial land after the manifest: verify says so."""
    s, _ = cv_train.build(_args())
    _run(s, 1)
    for kind in ("ckpt_corrupt", "ckpt_partial"):
        p = ckpt.save(str(tmp_path / kind), s, fault_plan=FaultPlan.parse(f"{kind}@1"))
        assert ckpt.verify(p) is False


def test_damaged_checkpoints_set_aside_and_garbage_collected(tiny_cv, tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    s, _ = cv_train.build(_args())
    for _ in range(3):
        _run(s, 1)
        ckpt.save(ckdir, s)
    names = sorted(d for d in os.listdir(ckdir) if d.startswith("round_"))
    for name in names[-2:]:
        _truncate(os.path.join(ckdir, name))
    s2, _ = cv_train.build(_args())
    restored = ckpt.restore_latest(ckdir, s2)
    assert restored.endswith(names[0]) and s2.round == 1
    damaged = sorted(d for d in os.listdir(ckdir) if d.endswith(".damaged"))
    assert damaged == [f"{names[-2]}.damaged", f"{names[-1]}.damaged"]
    assert ckpt.latest(ckdir) == os.path.abspath(os.path.join(ckdir, names[0]))

    _run(s2, 3)
    _truncate(ckpt.save(ckdir, s2))  # round_00000004
    s3, _ = cv_train.build(_args())
    ckpt.restore_latest(ckdir, s3)
    err = capsys.readouterr().err
    assert "checkpoint GC: deleted 1 damaged" in err
    damaged = sorted(d for d in os.listdir(ckdir) if d.endswith(".damaged"))
    assert len(damaged) == 2 and f"{names[-2]}.damaged" not in damaged


def test_all_damaged_dir_refuses_fresh_restart(tiny_cv, tmp_path):
    ckdir = str(tmp_path / "ck")
    s, _ = cv_train.build(_args(("--fault_plan", "ckpt_corrupt@1")))
    _run(s, 1)
    ckpt.save(ckdir, s, fault_plan=s.fault_plan)
    s2, _ = cv_train.build(_args())
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        ckpt.restore_latest(ckdir, s2)
    with pytest.raises(RuntimeError, match="only damaged"):
        ckpt.restore_latest(ckdir, s2)
    assert ckpt.restore_latest(str(tmp_path / "fresh"), s2) is None


def test_cli_checkpoint_resume_equals_uninterrupted(tiny_cv, tmp_path):
    """Through the CLI: 3 rounds with a checkpoint, then --resume to 6,
    equals 6 uninterrupted rounds bitwise (sketch mode, async loop)."""
    from test_torch_runner import _argv

    sa = cv_train.main(_argv(("--num_rounds", "6"), "sketch"))
    ck = ["--checkpoint_dir", str(tmp_path / "ck")]
    cv_train.main(_argv(("--num_rounds", "3", *ck), "sketch"))
    sc = cv_train.main(_argv(("--num_rounds", "6", "--resume", *ck), "sketch"))
    assert sc.round == 6 and sc.run_stats.rounds == 3
    assert sa.comm_mb_total == sc.comm_mb_total
    _assert_state_equal(sa, sc)
