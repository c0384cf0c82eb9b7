"""The port's run loop against the JAX package's, on the CPU: the same
inputs go through both and the results are compared.

- ``plan_block`` over a grid of (round, total, eval_every,
  checkpoint_every, K): identical lr lists (exact).
- ``auto_inflight`` over a grid: identical depths (exact).
- ``FaultPlan.parse`` of every ported kind, the cohort kinds included:
  identical specs (exact).
- Round-batch assembly: identical cohorts and batches (bitwise); the
  reference draws rows with its native splitmix64/Floyd sampler.
- The JAX ``cv_train.main`` (sync loop, the tests' flax ``_TinyNet``)
  against the port's ``cv_train.main`` (async loop, the torch twin with
  the same initial weights), 4 rounds, preempted after round 1 with an
  emergency checkpoint at 2, then resumed:
  - the cohort ids and batches of every round: bitwise;
  - the restored round and comm_mb at resume: exact;
  - uncompressed: final params within atol 1e-5 (the two packages' CPU
    matmuls sum in different orders, about 1e-7 per round);
  - sketch: the final eval row's test_loss within rtol 1e-5, the sets of
    moved coordinates agreeing on at least 99% of their union (a top-k
    may swap a near-tie, as in tests/test_torch_round.py), and the common
    coordinates within atol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import cv_train as jcv
from commefficient_tpu.data.cifar import load_cifar_fed as jload
from commefficient_tpu.federated import api as japi
from commefficient_tpu.resilience import FaultPlan as JFaultPlan
from commefficient_tpu.runner import auto_inflight as jauto_inflight
from commefficient_tpu.utils import checkpoint as jckpt
from commefficient_tpu.utils.schedules import triangular as jtriangular
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch.data.cifar import load_cifar_fed as tload
from commefficient_tpu_torch.federated import api as tapi
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.resilience.faults import KINDS
from commefficient_tpu_torch.runner import auto_inflight as tauto_inflight
from commefficient_tpu_torch.utils import checkpoint as tckpt
from commefficient_tpu_torch.utils.schedules import triangular as ttriangular
from test_torch_runner import TINY_PATHS, TinyNet

torch.set_num_threads(2)


def test_plan_block_matches_jax():
    for total in (1, 5, 7, 12):
        for eval_every in (1, 3, 4):
            for ck in (0, 2, 5):
                for K in (1, 2, 3, 8):
                    for start in range(total):
                        jo = japi.FedOptimizer(jtriangular(0.4, 5, 24), 13)
                        to = tapi.FedOptimizer(ttriangular(0.4, 5, 24), 13)
                        jo.round = to.round = start
                        got = tapi.plan_block(to, start, total, eval_every, ck, K)
                        want = japi.plan_block(jo, start, total, eval_every, ck, K)
                        assert got == want and to.round == jo.round, (start, total,
                                                                      eval_every, ck, K)


def test_auto_inflight_matches_jax():
    for rtt in (0.0, 0.01, 0.1, 1.0, 5.0, 70.0, 300.0):
        for round_ms in (-1.0, 0.0, 0.5, 5.0, 24.0, 70.0, 185.0, 2000.0):
            assert tauto_inflight(rtt, round_ms) == jauto_inflight(rtt, round_ms), (rtt,
                                                                                   round_ms)


PLANS = ["preempt@3", "stall@2:secs=1.5", "eval_stall@4:secs=0.5", "data_fail@1,2:times=2",
         "nonfinite@4", "nonfinite@4:value=inf", "ckpt_fail@2:times=1", "ckpt_corrupt@2",
         "ckpt_partial@2,5", "ckpt_fail:times=3", "preempt@1;stall@0:secs=0.1;seed=7",
         "client_drop@2:clients=0+3", "client_straggle@1:clients=2,secs=0.01",
         "client_poison@2:clients=1,value=big;client_poison:clients=0",
         "wire_corrupt@1:clients=0+2;wire_truncate@2:clients=1",
         "wire_dup@1:clients=3;conn_drop@2:clients=0", "wire_delay@1:clients=1,secs=0.25",
         "client_signflip@1:clients=0+2;client_scale@2:clients=1,factor=50",
         "seed=7;client_collude@3:frac=0.25;client_normride@2:clients=0,ride=0.9"]


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parse_matches_jax(text):
    tp, jp = TFaultPlan.parse(text), JFaultPlan.parse(text)
    assert tp.seed == jp.seed
    assert [(s.kind, s.rounds, s.params) for s in tp.specs] == \
        [(s.kind, s.rounds, s.params) for s in jp.specs]


def test_fault_plan_kinds_cover_every_run_loop_site():
    assert {e.split("@")[0].split(":")[0] for t in PLANS for e in t.split(";")} - {
        "seed=7"} == set(KINDS)


@pytest.mark.parametrize("clients,batch,train", [(8, 4, 64), (100, 8, 10000), (10, 2, 100),
                                                 (7, 30, 64)])
def test_round_batches_match_jax(clients, batch, train):
    """Cohorts and batches of five rounds from the same seed, bitwise: the
    port draws rows as the reference's native sampler does."""
    jset, _, _ = jload("cifar10", clients, False, "/nonexistent", 42, synthetic_train=train,
                       synthetic_test=8)
    tset, _, _ = tload("cifar10", clients, False, "/nonexistent", 42, synthetic_train=train,
                       synthetic_test=8)
    rj, rt = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(5):
        ij, it = jset.sample_clients(rj, 8), tset.sample_clients(rt, 8)
        np.testing.assert_array_equal(ij, it)
        bj, bt = jset.client_batch(rj, ij, batch), tset.client_batch(rt, it, batch)
        assert bj.keys() == bt.keys()
        for k in bj:
            np.testing.assert_array_equal(bj[k], bt[k])


# ------------------------------------------------- the CLI, both packages

MODES = {
    "uncompressed": ["--mode", "uncompressed"],
    "sketch": ["--mode", "sketch", "--k", "100", "--num_cols", "2000", "--num_rows", "3"],
}


def _flax_tiny():
    import flax.linen as nn

    class _TinyNet(nn.Module):
        num_classes: int = 10
        dtype: str = "float32"

        @nn.compact
        def __call__(self, x, train=False):
            x = x.reshape((x.shape[0], -1))
            x = nn.relu(nn.Dense(32)(x))
            return nn.Dense(self.num_classes)(x)

    return _TinyNet


@pytest.fixture()
def both_tiny(monkeypatch):
    """Both CLIs on 64 synthetic images and the tiny MLP; the port's twin
    starts from the flax init of the same seed. Every prepared round and
    every resume is recorded."""
    flax_tiny = _flax_tiny()

    def tiny_loader(orig):
        def tiny(*a, **kw):
            kw.update(synthetic_train=64, synthetic_test=32)
            return orig(*a, **kw)
        return tiny

    monkeypatch.setattr(jcv, "load_cifar_fed", tiny_loader(jcv.load_cifar_fed))
    monkeypatch.setattr(jcv, "ResNet9", flax_tiny)
    monkeypatch.setattr(tcv, "load_cifar_fed", tiny_loader(tcv.load_cifar_fed))
    monkeypatch.setattr(tcv, "ResNet9", TinyNet)
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)

    def init_from_flax(model, seed):
        params = flax_tiny().init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))["params"]
        with torch.no_grad():
            for name, p in model.named_parameters():
                layer, leaf = TINY_PATHS[name]
                a = np.asarray(params[layer][leaf])
                p.copy_(torch.from_numpy(np.array(a.T if a.ndim == 2 else a)))

    monkeypatch.setattr(tcv, "init_weights", init_from_flax)
    rec = {"jax": {}, "torch": {}, "resumed": {}}
    for name, api in (("jax", japi), ("torch", tapi)):
        orig = api.FederatedSession.prepare_round

        def prepare(self, rnd=None, _orig=orig, _name=name):
            prep = _orig(self, rnd)
            rec[_name].setdefault(prep.rnd, []).append(
                (np.asarray(prep.ids), {k: np.asarray(v) for k, v in prep.batch.items()}))
            return prep

        monkeypatch.setattr(api.FederatedSession, "prepare_round", prepare)
    for name, mod in (("jax", jckpt), ("torch", tckpt)):
        orig_restore = mod.restore_latest

        def restore_latest(d, session, _orig=orig_restore, _name=name):
            path = _orig(d, session)
            rec["resumed"][_name] = (session.round, session.comm_mb_total)
            return path

        monkeypatch.setattr(mod, "restore_latest", restore_latest)
    return rec


def _run_with_resume(main, argv, ckdir):
    chaos = ["--checkpoint_dir", ckdir, "--fault_plan", "preempt@1"]
    with pytest.raises(SystemExit) as ei:
        main(argv + chaos)
    assert ei.value.code == 75
    assert sorted(d for d in os.listdir(ckdir) if d.startswith("round_"))[-1] == \
        "round_00000002"
    return main(argv + chaos + ["--resume"])


@pytest.mark.parametrize("mode", ["uncompressed", "sketch"])
def test_cli_preempt_resume_matches_jax(both_tiny, tmp_path, mode):
    rec = both_tiny
    common = ["--dataset", "cifar10", *MODES[mode], "--num_clients", "8", "--num_workers", "2",
              "--local_batch_size", "4", "--lr_scale", "0.05", "--data_root", "/nonexistent",
              "--num_rounds", "4", "--eval_every", "2"]
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    # --num_devices 1: the reference's single-device round, not the
    # sharded round the tests' 8-device CPU mesh would pick
    js = _run_with_resume(jcv.main, common + ["--sync_loop", "--num_devices", "1",
                                              "--log_jsonl", jlog],
                          str(tmp_path / "jck"))
    ts = _run_with_resume(tcv.main, common + ["--device", "cpu", "--log_jsonl", tlog],
                          str(tmp_path / "tck"))
    assert js.round == ts.round == 4

    for rnd in range(4):
        seen = rec["jax"][rnd] + rec["torch"][rnd]
        ids0, b0 = seen[0]
        for ids, b in seen[1:]:
            np.testing.assert_array_equal(ids, ids0)
            assert b.keys() == b0.keys()
            for k in b0:
                np.testing.assert_array_equal(b[k], b0[k], err_msg=f"round {rnd} {k}")
    assert rec["resumed"]["jax"] == rec["resumed"]["torch"]
    assert rec["resumed"]["torch"][0] == 2

    jrows = [json.loads(line) for line in open(jlog)]
    trows = [json.loads(line) for line in open(tlog)]
    # the preempted runs exit before round 2's eval; the resumed ones log 4
    assert [r["round"] for r in jrows] == [r["round"] for r in trows] == [4]
    assert trows[-1]["comm_mb"] == jrows[-1]["comm_mb"]

    jp = np.asarray(ravel_pytree(jax.device_get(js.state["params"]))[0])
    tp = ts.state["params"].numpy()
    if mode == "uncompressed":
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
        return
    np.testing.assert_allclose(trows[-1]["test_loss"], jrows[-1]["test_loss"], rtol=1e-5)
    p0 = ts.layout.flatten({k: v.detach() for k, v in _initial_twin().items()}).numpy()
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    assert t_set and len(j_set & t_set) >= 0.99 * len(j_set | t_set)
    common_idx = np.array(sorted(j_set & t_set))
    np.testing.assert_allclose(tp[common_idx], jp[common_idx], rtol=0, atol=1e-5)


def _initial_twin():
    model = TinyNet()
    tcv.init_weights(model, 42)
    return dict(model.named_parameters())
