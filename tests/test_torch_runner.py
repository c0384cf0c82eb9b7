"""The port's run loop (``commefficient_tpu_torch/runner/``), mirroring
tests/test_runner.py: the async loop (background prefetch, metrics read
at drains, checkpoint writes on a writer thread) must give bitwise the
final state and logged rows of ``--sync_loop``, including in blocks of
rounds and across a preemption and resume, because both run the same step
in the same order on the same host RNG stream.

The loop is model-agnostic, so the CLI runs a twin of the JAX tests'
``_TinyNet`` (Dense(32) -> ReLU -> Dense(10)) on 64 synthetic CIFAR
images, on the CPU."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.federated.api import FedOptimizer
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.runner import (AsyncCheckpointWriter, RoundPrefetcher,
                                            RunnerConfig, run_loop)
from commefficient_tpu_torch.utils import checkpoint as ckpt
from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

torch.set_num_threads(2)

LR = 0.05
# the twin's parameters -> the flax _TinyNet's paths (ravel order: Dense_0
# bias, kernel, then Dense_1)
TINY_PATHS = {"fc0.weight": ("Dense_0", "kernel"), "fc0.bias": ("Dense_0", "bias"),
              "fc1.weight": ("Dense_1", "kernel"), "fc1.bias": ("Dense_1", "bias")}


class TinyNet(nn.Module):
    def __init__(self, num_classes: int = 10, dtype: str = "float32"):
        super().__init__()
        assert dtype == "float32"  # the runs that use the stand-in are float32
        self.fc0 = nn.Linear(32 * 32 * 3, 32)
        self.fc1 = nn.Linear(32, num_classes)

    def forward(self, x, train=False):
        return self.fc1(torch.relu(self.fc0(x.reshape(x.shape[0], -1)))), {}


def init_tiny(model, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy((0.05 * rng.standard_normal(p.shape)).astype(np.float32)))


@pytest.fixture()
def tiny_cv(monkeypatch):
    orig = cv_train.load_cifar_fed

    def tiny(*a, **kw):
        kw.update(synthetic_train=64, synthetic_test=32)
        return orig(*a, **kw)

    monkeypatch.setattr(cv_train, "load_cifar_fed", tiny)
    monkeypatch.setattr(cv_train, "ResNet9", TinyNet)
    monkeypatch.setattr(cv_train, "init_weights", init_tiny)
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)


MODES = {
    "uncompressed": ["--mode", "uncompressed"],
    "sketch": ["--mode", "sketch", "--k", "100", "--num_cols", "2000", "--num_rows", "3"],
}


def _argv(extra=(), mode="uncompressed"):
    return ["--dataset", "cifar10", *MODES[mode], "--num_clients", "8",
            "--num_workers", "2", "--local_batch_size", "4", "--lr_scale", "0.05",
            "--weight_decay", "0", "--data_root", "/nonexistent", "--device", "cpu", *extra]


def _args(extra=(), mode="uncompressed"):
    return resolve_defaults(make_parser().parse_args(_argv(extra, mode)))


def _rows(path):
    """Logged rows minus wall clock (the one loop-dependent field)."""
    rows = [json.loads(line) for line in open(path)]
    for r in rows:
        r.pop("time_s")
    return rows


def _assert_state_equal(sa, sb):
    assert torch.equal(sa.state["params"], sb.state["params"])
    for part in ("mode_state", "net_state"):
        assert sa.state[part].keys() == sb.state[part].keys()
        for k in sa.state[part]:
            assert torch.equal(sa.state[part][k], sb.state[part][k]), (part, k)


# ------------------------------------------------- the acceptance headline


@pytest.mark.parametrize("mode", ["uncompressed", "sketch"])
@pytest.mark.parametrize("rpd", [1, 3])
def test_async_loop_bit_identical_to_sync(tiny_cv, tmp_path, mode, rpd):
    """7 rounds through the real CLI with eval every 3 and a checkpoint
    every 2 rounds, so blocks of 3 are cut at both boundaries: the async
    loop's final state and every logged row (but time_s) must equal
    --sync_loop's bitwise."""
    base = _argv(("--num_rounds", "7", "--eval_every", "3", "--checkpoint_every", "2",
                  "--rounds_per_dispatch", str(rpd)), mode)
    la, lb = str(tmp_path / "sync.jsonl"), str(tmp_path / "async.jsonl")
    sa = cv_train.main(base + ["--sync_loop", "--log_jsonl", la,
                               "--checkpoint_dir", str(tmp_path / "a")])
    sb = cv_train.main(base + ["--log_jsonl", lb, "--checkpoint_dir", str(tmp_path / "b")])
    assert sa.round == sb.round == 7
    _assert_state_equal(sa, sb)
    rows_a, rows_b = _rows(la), _rows(lb)
    assert [r["round"] for r in rows_a] == [3, 6, 7] and rows_a == rows_b
    assert sb.run_stats.async_checkpoints == 3 and sa.run_stats.sync_checkpoints == 4
    if rpd > 1:
        # the blocks were cut at the boundaries: 2 | 1 | 1 2 | 2 | 1 drains
        assert sa.run_stats.window_rounds == [2, 1, 1, 2, 1]


def test_async_loop_exact_under_thread_switch_stress(tiny_cv, tmp_path):
    """The prefetch thread (host RNG draws), the writer thread (a save of
    the committed state every round) and the main thread (dispatch,
    commit) share the session. With the interpreter switching threads
    every 10 us, the async run must still end bitwise equal to the sync
    run: a draw taken out of order or a torn (state, round, RNG) view
    would break it."""
    base = _argv(("--num_rounds", "8", "--eval_every", "4", "--checkpoint_every", "1",
                  "--prefetch_depth", "4", "--max_inflight", "3"), "sketch")
    sa = cv_train.main(base + ["--sync_loop"])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sb = cv_train.main(base + ["--checkpoint_dir", str(tmp_path / "ck")])
    finally:
        sys.setswitchinterval(old)
    _assert_state_equal(sa, sb)
    assert sb.run_stats.async_checkpoints == 8
    for name in sorted(os.listdir(tmp_path / "ck")):
        assert ckpt.verify(str(tmp_path / "ck" / name)) is True, name


def test_run_rounds_block_equals_single_rounds(tiny_cv):
    """A block of 3 rounds in one dispatch (one host-to-device copy of the
    stacked batches, [K] metrics) equals three single rounds bitwise."""
    a, _ = cv_train.build(_args(mode="sketch"))
    b, _ = cv_train.build(_args(mode="sketch"))
    ma = [a.run_round(lr) for lr in (0.01, 0.02, 0.03)]
    mb = b.run_rounds([0.01, 0.02, 0.03])
    assert ma == mb and a.round == b.round == 3
    assert a.comm_mb_total == b.comm_mb_total
    _assert_state_equal(a, b)


def test_async_loop_preempt_resume_bit_identical(tiny_cv, tmp_path):
    """SIGTERM mid-block under the async loop (prefetcher ahead, rounds in
    flight, periodic saves on the writer thread): drain -> emergency
    checkpoint -> exit 75; the --resume run must end bitwise equal to an
    uninterrupted --sync_loop run."""
    base = _argv(("--num_rounds", "6"))
    sa = cv_train.main(base + ["--sync_loop"])

    ckdir = str(tmp_path / "ck")
    chaos = ["--checkpoint_dir", ckdir, "--checkpoint_every", "2", "--fault_plan", "preempt@2"]
    with pytest.raises(SystemExit) as ei:
        cv_train.main(base + chaos)
    assert ei.value.code == EXIT_RESUMABLE
    # the SIGTERM fired as round 2 dispatched; the drain let it commit, so
    # the emergency checkpoint is a verified round-3 boundary
    names = sorted(d for d in os.listdir(ckdir) if d.startswith("round_"))
    assert names[-1] == "round_00000003"
    assert ckpt.verify(os.path.join(ckdir, names[-1])) is True

    sc = cv_train.main(base + chaos + ["--resume"])
    assert sc.round == 6
    _assert_state_equal(sa, sc)


def test_prefetcher_deterministic_under_injected_data_fault(tiny_cv):
    """A data load failing transiently on the prefetch thread recovers by
    the retry wrapper's RNG restore and serves the same rounds."""
    a, _ = cv_train.build(_args())
    ms_a = [a.run_round(LR) for _ in range(4)]
    b, _ = cv_train.build(_args(("--fault_plan", "data_fail@1:times=2")))
    src = RoundPrefetcher(b, b.round, depth=2)
    try:
        ms_b = [b.commit_round(b.dispatch_round(src.next(), LR))[0] for _ in range(4)]
    finally:
        src.stop()
    assert [m["loss_sum"] for m in ms_a] == [m["loss_sum"] for m in ms_b]
    _assert_state_equal(a, b)


def test_async_periodic_checkpoints_land_verified(tiny_cv, tmp_path):
    """Periodic saves ride the writer thread; by the end every committed
    checkpoint verifies, the final round's save included, and no staging
    directory is left."""
    ckdir = str(tmp_path / "ck")
    s = cv_train.main(_argv(("--num_rounds", "6", "--checkpoint_dir", ckdir,
                             "--checkpoint_every", "2")))
    assert s.round == 6
    names = sorted(d for d in os.listdir(ckdir) if d.startswith("round_"))
    assert names and names[-1] == "round_00000006"
    for name in names:
        assert ckpt.verify(os.path.join(ckdir, name)) is True
    assert not [d for d in os.listdir(ckdir) if d.startswith(".tmp_round_")]
    assert len(s.run_stats.checkpoints) == 4  # 3 periodic + the final
    for t in s.run_stats.checkpoints:
        assert set(t) == {"copy_ms", "write_ms", "verify_ms"}


# ----------------------------------------------------- prefetcher contract


def test_prefetcher_serves_rounds_in_order(tiny_cv):
    """The prefetched sequence equals inline prepare_round calls on an
    identically seeded session: cohorts, batches and snapshot chain."""
    a, _ = cv_train.build(_args())
    b, _ = cv_train.build(_args())
    inline = [a.prepare_round(i) for i in range(3)]
    src = RoundPrefetcher(b, 0, depth=2)
    try:
        fetched = [src.next() for _ in range(3)]
    finally:
        src.stop()
    for pa, pb in zip(inline, fetched):
        assert pa.rnd == pb.rnd
        np.testing.assert_array_equal(pa.ids, pb.ids)
        assert pa.batch.keys() == pb.batch.keys()
        for k in pa.batch:
            assert torch.equal(pa.batch[k], pb.batch[k]), k
        np.testing.assert_array_equal(pa.snapshot[1], pb.snapshot[1])
        assert pa.snapshot[2:] == pb.snapshot[2:]


def test_prefetcher_stop_unblocks_producer(tiny_cv):
    """stop() joins a producer blocked on a full queue."""
    b, _ = cv_train.build(_args())
    src = RoundPrefetcher(b, 0, depth=1)
    src.next()
    time.sleep(0.05)  # let it block on the full queue
    src.stop()
    assert not src._pf._thread.is_alive()


def test_prefetcher_reraises_a_producer_failure(tiny_cv):
    """A preparation that fails raises in the loop, at next(). (A load that
    fails past its retries does not: it degrades the round to a masked
    cohort, tests/test_torch_cohort_faults.py; a fault site naming a cohort
    position the round does not have fails.)"""
    b, _ = cv_train.build(_args(("--fault_plan", "client_drop@1:clients=9",)))
    src = RoundPrefetcher(b, 0, depth=2)
    try:
        src.next()  # round 0 is clean
        with pytest.raises(ValueError, match="out of range"):
            src.next()
    finally:
        src.stop()


# --------------------------------------------------------- writer contract


def test_writer_coalesces_requests():
    gate = threading.Event()
    calls = []

    def save():
        gate.wait(5)
        calls.append(1)
        return f"p{len(calls)}"

    w = AsyncCheckpointWriter(save)
    w.request()
    deadline = time.monotonic() + 5
    while not w._busy and time.monotonic() < deadline:
        time.sleep(0.005)  # wait until the first save is in flight
    for _ in range(4):
        w.request()  # all four coalesce into one follow-up save
    gate.set()
    w.drain()
    w.close()
    assert len(calls) == 2
    assert w.saves_completed == 2 and w.saves_coalesced == 4
    assert w.last_path == "p2"


def test_writer_reraises_failure_at_drain():
    def bad():
        raise OSError("disk gone")

    w = AsyncCheckpointWriter(bad, alert=lambda m: None)
    w.request()
    with pytest.raises(OSError, match="disk gone"):
        w.drain()
    w.drain()  # surfaced once; the writer stays usable
    w.close()


def test_writer_close_finishes_outstanding_work():
    calls = []
    w = AsyncCheckpointWriter(lambda: calls.append(1) or "p")
    w.request()
    w.close()
    assert calls == [1]
    assert not w._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        w.request()


def test_superseded_inflight_releases_state_batch_commit_exact(tiny_cv):
    """Once a newer dispatch supersedes an in-flight round, its state is
    released; the batch commit still gives the sync loop's per-round
    metrics and final state, and releasing the newest entry is refused."""
    s, _ = cv_train.build(_args())
    i1 = s.dispatch_round(s.prepare_round(0), LR)
    i2 = s.dispatch_round(s.prepare_round(1), LR)
    i1.release_state()
    assert i1.new_state is None
    out = s.commit_rounds([i1, i2], s.fetch_metrics([i1, i2]))
    assert len(out) == 2 and s.round == 2

    b, _ = cv_train.build(_args())
    mb = [b.run_round(LR) for _ in range(2)]
    assert out == mb
    _assert_state_equal(s, b)
    i3 = s.dispatch_round(s.prepare_round(2), LR)
    i3.release_state()
    with pytest.raises(RuntimeError, match="release_state"):
        s.commit_rounds([i3], s.fetch_metrics([i3]))


def test_async_writer_failure_does_not_block_final_save(tiny_cv, tmp_path):
    """A periodic save failing on the writer thread must not block the
    final synchronous save, the corrective action."""
    s, _ = cv_train.build(_args())
    calls = []

    def flaky_save():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("transient ENOSPC")
        return "saved"

    stats = run_loop(s, FedOptimizer(lambda _: LR, 1),
                     RunnerConfig(total_rounds=4, eval_every=4, checkpoint_every=2,
                                  checkpoint_dir=str(tmp_path / "ck")),
                     save_ckpt=flaky_save)
    assert s.round == 4
    assert stats.async_checkpoints >= 1
    assert len(calls) >= 2  # the failed periodic save and the final one


def test_session_reusable_after_async_loop(tiny_cv):
    """run_loop's exit rewinds the live host RNG to the committed boundary
    (the prefetcher drew it for rounds never dispatched), so driving the
    session on stays on the sync loop's sequence."""
    a, _ = cv_train.build(_args())
    b, _ = cv_train.build(_args())
    sa = run_loop(a, FedOptimizer(lambda _: LR, 1), RunnerConfig(total_rounds=3, eval_every=3))
    sb = run_loop(b, FedOptimizer(lambda _: LR, 1),
                  RunnerConfig(total_rounds=3, eval_every=3, sync_loop=True))
    _assert_state_equal(a, b)
    assert a.run_round(LR) == b.run_round(LR)
    _assert_state_equal(a, b)
    # each drain's window covers the rounds it committed; the sync loop
    # drains once per round, and only the async loop measured an RTT
    assert sum(sa.window_rounds) == sum(sb.window_rounds) == 3
    assert sb.window_rounds == [1, 1, 1] and len(sb.round_ms) == 3
    assert sa.rtt_ms > 0 and sb.rtt_ms == 0 and sa.max_inflight_used >= 2


def test_evaluate_refuses_inflight_pipeline(tiny_cv):
    """Eval runs only at a drained boundary."""
    s, test_set = cv_train.build(_args())
    infl = s.dispatch_round(s.prepare_round(0), LR)
    with pytest.raises(RuntimeError, match="in-flight"):
        s.evaluate(test_set, 32)
    s.commit_round(infl)
    s.evaluate(test_set, 32)
