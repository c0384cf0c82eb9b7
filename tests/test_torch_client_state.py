"""The port's client state (local_topk's [num_clients, d] local momentum
and local error) through the session, the run loop and checkpoints, on the
CPU with the tiny MLP twin of tests/test_torch_runner.py:

- the async loop equals ``--sync_loop`` bitwise, client state included,
  with periodic checkpoints on the writer thread;
- a block of rounds falls back to per-round dispatch (the rows are
  gathered and scattered around each round);
- preempt -> emergency checkpoint -> resume restores the client state and
  ends bitwise equal to the uninterrupted run;
- a checkpoint of another mode or client count is refused and left in
  place;
- only the rows of the round's cohort change, and the committed client
  state is never written in place.
"""

import os

import numpy as np
import pytest
import torch

from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.utils import checkpoint as ckpt
from test_torch_runner import _args, _argv, _assert_state_equal, _rows, tiny_cv  # noqa: F401

torch.set_num_threads(2)

LOCAL = ["--mode", "local_topk", "--k", "100", "--num_workers", "3"]


def _assert_clients_equal(sa, sb):
    assert sa.client_state.keys() == sb.client_state.keys() == {"error", "momentum"}
    for k in sa.client_state:
        assert torch.equal(sa.client_state[k], sb.client_state[k]), k


@pytest.mark.parametrize("rpd", [1, 3])
def test_async_loop_bit_identical_to_sync_with_client_state(tiny_cv, tmp_path, rpd):
    base = _argv(LOCAL + ["--num_rounds", "7", "--eval_every", "3", "--checkpoint_every",
                          "2", "--rounds_per_dispatch", str(rpd)])
    la, lb = str(tmp_path / "sync.jsonl"), str(tmp_path / "async.jsonl")
    sa = cv_train.main(base + ["--sync_loop", "--log_jsonl", la,
                               "--checkpoint_dir", str(tmp_path / "a")])
    sb = cv_train.main(base + ["--log_jsonl", lb, "--checkpoint_dir", str(tmp_path / "b")])
    assert sa.round == sb.round == 7
    _assert_state_equal(sa, sb)
    _assert_clients_equal(sa, sb)
    assert _rows(la) == _rows(lb)
    assert sa.client_state["error"].any() and sa.client_state["momentum"].any()


def test_blocks_fall_back_to_per_round_dispatch(tiny_cv, monkeypatch):
    s, _ = cv_train.build(_args(LOCAL))
    assert s.client_state is not None and not s.supports_block_dispatch
    with pytest.raises(ValueError, match="per-client persistent state"):
        engine.make_multi_round_step(s.train_loss_fn, s.cfg, s.layout)

    def no_block(*a, **kw):
        raise AssertionError("dispatch_block with client state")

    monkeypatch.setattr(type(s), "dispatch_block", no_block)
    ms = s.run_rounds([0.01, 0.02, 0.03])
    assert len(ms) == 3 and s.round == 3
    ref, _ = cv_train.build(_args(LOCAL))
    for lr in (0.01, 0.02, 0.03):
        ref.run_round(lr)
    _assert_state_equal(s, ref)
    _assert_clients_equal(s, ref)


def test_round_rewrites_only_the_cohort_rows_out_of_place(tiny_cv):
    s, _ = cv_train.build(_args(LOCAL))
    s.run_round(0.05)
    before = {k: v.clone() for k, v in s.client_state.items()}
    held = s.client_state
    prep = s.prepare_round()
    s.commit_round(s.dispatch_round(prep, 0.05))
    for k in before:
        assert torch.equal(held[k], before[k])  # the committed tensor is untouched
        changed = torch.nonzero((s.client_state[k] != before[k]).any(1)).flatten().tolist()
        assert changed and set(changed) <= set(prep.ids.tolist()), (k, changed, prep.ids)


def test_preempt_resume_restores_client_state_bitwise(tiny_cv, tmp_path):
    base = _argv(LOCAL + ["--num_rounds", "6"])
    sa = cv_train.main(base + ["--sync_loop"])
    ckdir = str(tmp_path / "ck")
    chaos = ["--checkpoint_dir", ckdir, "--checkpoint_every", "2", "--fault_plan", "preempt@2"]
    with pytest.raises(SystemExit) as ei:
        cv_train.main(base + chaos)
    assert ei.value.code == EXIT_RESUMABLE
    names = sorted(d for d in os.listdir(ckdir) if d.startswith("round_"))
    assert names[-1] == "round_00000003"
    payload = torch.load(os.path.join(ckdir, names[-1], ckpt.STATE_FILE), weights_only=True)
    assert set(payload["client_state"]) == {"error", "momentum"}
    sc = cv_train.main(base + chaos + ["--resume"])
    assert sc.round == 6
    _assert_state_equal(sa, sc)
    _assert_clients_equal(sa, sc)


@pytest.mark.parametrize("other", [["--mode", "true_topk", "--k", "100"],
                                   LOCAL + ["--num_clients", "6"]])
def test_checkpoint_of_another_mode_or_client_count_is_refused(tiny_cv, tmp_path, other):
    s, _ = cv_train.build(_args(LOCAL))
    s.run_round(0.05)
    path = ckpt.save(str(tmp_path), s)
    t, _ = cv_train.build(_args(other))
    with pytest.raises(ckpt.CheckpointMismatchError):
        ckpt.restore(path, t)
    with pytest.raises(ckpt.CheckpointMismatchError):
        ckpt.restore_latest(str(tmp_path), t)
    # refused, not set aside as damaged: the same mode still resumes from it
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    u, _ = cv_train.build(_args(LOCAL))
    assert ckpt.restore_latest(str(tmp_path), u) == path and u.round == 1
    _assert_clients_equal(s, u)


def test_client_state_allocated_per_key_on_the_session_device(tiny_cv):
    s, _ = cv_train.build(_args(LOCAL))
    for k, v in s.client_state.items():
        assert tuple(v.shape) == (8, s.layout.d) and v.device == s.device, k
    virt, _ = cv_train.build(_args(LOCAL + ["--error_type", "virtual",
                                            "--momentum_type", "virtual"]))
    assert virt.client_state is None and virt.supports_block_dispatch
    np.testing.assert_array_equal(
        sorted(cv_train.build(_args(LOCAL + ["--momentum", "0"]))[0].client_state), ["error"])
