"""Client participation in the port, held against the JAX package:
the cohort fault kinds, the dropped-client requeue (fifo and aged), the
degraded data load and the queue across prefetch, rollback and
checkpoints.

Tolerances: fault parsing, ``client_faults`` output, cohorts (id for id),
``empty_batch`` and ``meta.json`` are bitwise against the reference;
inside the port, a masked round equals the round over the surviving
cohort bitwise (ResNet-9 at full width, batch-norm statistics included),
and async equals sync, and a resume the uninterrupted run, bitwise. A
round against the reference round is held as in tests/test_torch_round.py
(atol 1e-5 on the params, a top-k swap only at a near-tie)."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import cv_train as jcv
from commefficient_tpu.data.cifar import load_cifar_fed as jload
from commefficient_tpu.data.personachat import load_personachat_fed as jload_text
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu.resilience import FaultPlan as JFaultPlan
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch.data.cifar import load_cifar_fed as tload
from commefficient_tpu_torch.data.personachat import load_personachat_fed as tload_text
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.utils import checkpoint as ckpt
from test_torch_loop_parity import MODES, TINY_PATHS, TinyNet, _flax_tiny, both_tiny  # noqa: F401
from test_torch_runner import LR, _args, _argv, _assert_state_equal, _rows, tiny_cv  # noqa: F401

torch.set_num_threads(2)

SKETCH = dict(mode="sketch", k=100, num_rows=3, num_cols=2000, momentum=0.9,
              momentum_type="virtual", error_type="virtual")
UNCOMPRESSED = dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                    error_type="none")


# ------------------------------------------------------------ fault plan


def _specs(plan):
    return [(s.kind, s.rounds, s.params) for s in plan.specs]


def test_client_fault_kinds_parse_and_coerce_as_the_reference():
    text = ("client_drop@2:clients=0+3;client_poison@2:clients=1,value=big;"
            "client_straggle@1:clients=2,secs=0.01")
    tp = TFaultPlan.parse(text)
    assert _specs(tp) == _specs(JFaultPlan.parse(text))
    assert tp.spec("client_drop", 2).params["clients"] == (0, 3)
    assert tp.spec("client_poison", 2).params["value"] == "big"
    assert tp.spec("client_straggle", 1).params["secs"] == 0.01
    for bad in ("client_drop@1:clients=a+b", "client_drop@1:clients=-1",
                "client_poison@1:value=huge", "nonfinite@1:value=big"):
        for parse in (TFaultPlan.parse, JFaultPlan.parse):
            with pytest.raises(ValueError, match="bad value"):
                parse(bad)
    with pytest.raises(ValueError, match="unknown param"):
        TFaultPlan.parse("client_drop@1:client=0")
    # one-host preemption goes with the mesh, refused by name until then
    with pytest.raises(ValueError, match="'host_preempt'.*not ported.*item 7"):
        TFaultPlan.parse("host_preempt@3:host=1")


def test_validate_rounds_rejects_unreachable_client_sites():
    plan = TFaultPlan.parse("client_drop@7:clients=0;preempt@9")
    with pytest.raises(ValueError, match="can never fire"):
        plan.validate_rounds(6)
    plan.validate_rounds(8)  # client_drop@7 in range; preempt is not a client site
    TFaultPlan.parse("client_poison:clients=0").validate_rounds(1)  # unscheduled


def test_cli_validates_the_schedule_at_launch(tiny_cv):
    with pytest.raises(ValueError, match="can never fire"):
        tcv.main(_argv(("--num_rounds", "3", "--fault_plan", "client_drop@5:clients=0")))


def _batch(W, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.standard_normal((W, 2, 3)).astype(np.float32),
            "y": rng.randint(0, 9, (W, 2)).astype(np.int32),
            "mask": np.ones((W, 2), np.float32), "_valid": np.ones(W, np.float32)}


def test_client_faults_match_the_reference():
    """The same plan on the same numpy batch: equal batches (NaN where the
    reference has NaN), masks and dropped positions, once per (kind,
    round, positions); a round without a site passes the batch through."""
    text = ("client_drop@2:clients=0+3;client_poison@2:clients=1,value=nan;"
            "client_poison@2:clients=2,value=big;client_drop@2:clients=3")
    tp, jp = TFaultPlan.parse(text), JFaultPlan.parse(text)
    W = 4
    for _ in range(2):  # the second call finds every site fired
        tb, tv, td = tp.client_faults(2, _batch(W), None, W)
        jb, jv, jd = jp.client_faults(2, _batch(W), None, W)
        assert td == jd
        np.testing.assert_array_equal(tv, jv)
        assert tb.keys() == jb.keys()
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    tb, tv, td = tp.client_faults(2, _batch(W), None, W)
    assert td == [] and tv is None
    b = _batch(W)
    out, valid, dropped = TFaultPlan.parse(text).client_faults(2, b, None, W)
    assert sorted(dropped) == [0, 3, 3]
    np.testing.assert_array_equal(valid, [0.0, 1.0, 1.0, 0.0])
    assert (out["x"][0] == 0).all() and np.isnan(out["x"][1]).all()
    assert (out["x"][2] == 1e6).all() and (out["y"][2] == b["y"][2]).all()
    np.testing.assert_array_equal(out["_valid"], np.ones(W, np.float32))  # control row
    b1, v1, d1 = tp.client_faults(1, b, None, W)
    assert d1 == [] and v1 is None and b1 is b
    with pytest.raises(ValueError, match="out of range"):
        TFaultPlan.parse("client_drop@0:clients=9").client_faults(0, b, None, W)


def test_client_straggle_sleeps_once():
    plan = TFaultPlan.parse("client_straggle@1:clients=0,secs=0.05")
    batch = {"x": np.ones((2, 2), np.float32)}
    t0 = time.monotonic()
    plan.client_faults(1, batch, None, 2)
    stalled = time.monotonic() - t0
    t0 = time.monotonic()
    plan.client_faults(1, batch, None, 2)  # one-shot per round
    assert stalled >= 0.05 and time.monotonic() - t0 < 0.05


# ------------------------------------------------------- empty batches


@pytest.mark.parametrize("local_iters", [1, 3])
def test_empty_batch_matches_the_reference(local_iters):
    jset, _, _ = jload("cifar10", 8, False, "/nonexistent", 42, synthetic_train=64,
                       synthetic_test=8)
    tset, _, _ = tload("cifar10", 8, False, "/nonexistent", 42, synthetic_train=64,
                       synthetic_test=8)
    jt, _, _ = jload_text("/nonexistent", 12, 32, 0)
    tt, _, _ = tload_text("/nonexistent", 12, 32, 0)
    for js, ts in ((jset, tset), (jt, tt)):
        jb, tb = js.empty_batch(3, 4, local_iters), ts.empty_batch(3, 4, local_iters)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


# ------------------------------------------- cohorts against the reference

COHORT_PLAN = ("client_drop@0:clients=0+1;client_drop@1:clients=0+2+3;data_fail@2:times=9;"
               "client_poison@3:clients=1,value=nan;client_drop@4:clients=3;"
               "client_straggle@4:clients=2,secs=0.01")


@pytest.mark.parametrize("policy", ["fifo", "aged"])
def test_cohorts_match_the_reference_session(both_tiny, tmp_path, policy):
    """Both CLIs over 6 rounds of drops, a degraded load and a poisoned
    client: every round's cohort id for id, its batch and validity mask
    bitwise; the communication total exactly (uplink charged for the
    clients that took part); the params as in tests/test_torch_loop_parity.py."""
    rec = both_tiny
    common = ["--dataset", "cifar10", *MODES["uncompressed"], "--num_clients", "16",
              "--num_workers", "4", "--local_batch_size", "4", "--lr_scale", "0.05",
              "--data_root", "/nonexistent", "--num_rounds", "6", "--eval_every", "6",
              "--fault_plan", COHORT_PLAN, "--max_retries", "0", "--requeue_policy", policy]
    js = jcv.main(common + ["--sync_loop", "--num_devices", "1",
                            "--log_jsonl", str(tmp_path / "j.jsonl")])
    ts = tcv.main(common + ["--device", "cpu", "--log_jsonl", str(tmp_path / "t.jsonl")])
    for rnd in range(6):
        (jids, jb), (tids, tb) = rec["jax"][rnd][0], rec["torch"][rnd][0]
        np.testing.assert_array_equal(tids, jids, err_msg=f"round {rnd} cohort")
        assert tb.keys() == jb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"round {rnd} {k}")
    valid = [rec["torch"][r][0][1]["_valid"] for r in range(6)]
    assert valid[2].sum() == 0 and valid[0].sum() == 2 and valid[1].sum() == 1
    # round 1 serves round 0's two dropped clients, round 3 the degraded cohort
    assert set(rec["torch"][0][0][0][:2]) <= set(rec["torch"][1][0][0])
    assert set(rec["torch"][2][0][0]) <= set(rec["torch"][3][0][0])
    jrow = json.loads(open(tmp_path / "j.jsonl").read().splitlines()[-1])
    trow = json.loads(open(tmp_path / "t.jsonl").read().splitlines()[-1])
    assert trow["comm_mb"] == jrow["comm_mb"]
    assert trow["nonfinite_rounds"] == jrow["nonfinite_rounds"] == 1
    assert ts.run_stats.clients_dropped == js.clients_dropped_total == 2 + 3 + 4 + 1
    assert list(ts._requeue_committed) == [int(i) for i in js._requeue_committed]
    jp = np.asarray(ravel_pytree(jax.device_get(js.state["params"]))[0])
    np.testing.assert_allclose(ts.state["params"].numpy(), jp, rtol=0, atol=1e-5)


# ---------------------------------------------------- the masked round


def _tiny_pair(seed=42):
    """The flax _TinyNet's params and the torch twin with the same
    weights."""
    fmodel = _flax_tiny()()
    params = jax.tree.map(np.asarray, fmodel.init(jax.random.PRNGKey(seed),
                                                  jnp.zeros((1, 32, 32, 3)))["params"])
    tmodel = TinyNet()
    with torch.no_grad():
        for name, p in tmodel.named_parameters():
            layer, leaf = TINY_PATHS[name]
            a = params[layer][leaf]
            p.copy_(torch.from_numpy(np.array(a.T if a.ndim == 2 else a)))
    return fmodel, params, tmodel


def _image_batch(W, B=4, seed=1):
    rng = np.random.RandomState(seed)
    return {"x": rng.standard_normal((W, B, 32, 32, 3)).astype(np.float32),
            "y": rng.randint(0, 10, (W, B)).astype(np.int32),
            "mask": np.ones((W, B), np.float32)}


@pytest.mark.parametrize("mode_kw", [SKETCH, UNCOMPRESSED], ids=["sketch", "uncompressed"])
def test_masked_round_matches_the_reference_round(monkeypatch, mode_kw):
    """One round with positions {0, 3} of 6 masked, through both engines on
    the same params, server state and batch (the masked rows hold NaN)."""
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)
    fmodel, params, tmodel = _tiny_pair()
    W = 6
    batch = _image_batch(W)
    batch["x"][[0, 3]] = np.nan
    batch["_valid"] = np.array([0, 1, 1, 0, 1, 1], np.float32)
    d = ravel_pytree(params)[0].size
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=5e-4,
                                on_nonfinite="skip")
    jstate = jengine.init_server_state(jcfg, params, {})
    jnew, _, jm = jax.jit(jengine.make_round_step(jloss(fmodel, True), jcfg))(
        jstate, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(0.1), jax.random.PRNGKey(0))
    layout = convert.FlatLayout(tmodel)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=d, **mode_kw), weight_decay=5e-4,
                                on_nonfinite="skip")
    tstate = tengine.init_server_state(
        tcfg, layout.flatten({k: v.detach() for k, v in tmodel.named_parameters()}), {})
    tnew, _, tm = tengine.make_round_step(tloss(tmodel, True), tcfg, layout)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, {}, 0.1)
    for k in ("loss_sum", "count", "correct", "participants", "nonfinite_rounds"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["participants"]) == 4 and float(tm["nonfinite_rounds"]) == 0
    p0 = tstate["params"].numpy()
    jp, tp = np.asarray(ravel_pytree(jnew["params"])[0]), tnew["params"].numpy()
    if mode_kw["mode"] == "sketch":
        j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
        assert len(j_set) == len(t_set) == mode_kw["k"]
        # a swap only at a near-tie of the k-th estimate (1e-5 relative)
        assert len(j_set ^ t_set) <= 2
        same = np.array(sorted(j_set & t_set))
        np.testing.assert_allclose(tp[same], jp[same], rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)


def _resnet(W, mode_kw, **eng_kw):
    model = ResNet9()
    init_weights(model, 0)
    layout = convert.FlatLayout(model)
    cfg = tengine.EngineConfig(mode=TModeConfig(d=layout.d, **mode_kw), weight_decay=5e-4,
                               **eng_kw)
    state = tengine.init_server_state(
        cfg, layout.flatten({k: p.detach() for k, p in model.named_parameters()}),
        {k: b.clone() for k, b in model.named_buffers()})
    batch = {k: torch.from_numpy(v) for k, v in _image_batch(W, B=2, seed=3).items()}
    return tengine.make_round_step(tloss(model, True), cfg, layout), state, batch


def _assert_rounds_equal(a, b):
    (sa, _, ma), (sb, _, mb) = a, b
    assert torch.equal(sa["params"], sb["params"])
    for part in ("mode_state", "net_state"):
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


SKETCH_FULL = dict(SKETCH, k=2000, num_rows=5, num_cols=65_536)


def _masked_and_alone(eng_kw):
    """ResNet-9 at full width, batch norm on: the round with positions
    {0, 3} of 6 masked and the round of the 4 survivors alone."""
    step, state, batch = _resnet(6, SKETCH_FULL, **eng_kw)
    masked = dict(batch, _valid=torch.tensor([0, 1, 1, 0, 1, 1], dtype=torch.float32))
    surv = [1, 2, 4, 5]
    alone = {k: v[surv] for k, v in batch.items()}
    alone["_valid"] = torch.ones(4)
    return step(state, masked, {}, 0.1), step(state, alone, {}, 0.1), state


@pytest.mark.parametrize("eng_kw", [{}, {"dp_clip": 1.0}], ids=["plain", "dp_clip"])
def test_masked_round_bit_identical_to_surviving_cohort(eng_kw):
    """At client_chunk=1 (one client a chunk, as the reference pins its
    own), positions {0, 3} of 6 masked give, bitwise, the round of the 4
    survivors alone (params, Vvelocity/Verror, batch-norm statistics,
    every metric): a masked client adds exact zeros to every sum."""
    masked, alone, _ = _masked_and_alone(dict(eng_kw, client_chunk=1))
    _assert_rounds_equal(masked, alone)


@pytest.mark.parametrize("eng_kw", [{}, {"dp_clip": 1.0}], ids=["plain", "dp_clip"])
def test_masked_round_matches_surviving_cohort_at_chunk_0(eng_kw):
    """At client_chunk=0 a vmap over 6 clients and one over 4 run their
    convolutions at other batch sizes, so the two rounds agree to rounding:
    Verror within atol 1e-6, the moved params within atol 1e-6 (a top-k
    swap only at a near-tie of the k-th estimate), the batch-norm
    statistics and metrics within rtol 1e-5, the participants exactly."""
    (sm, _, mm), (sa, _, ma), state = _masked_and_alone(eng_kw)
    p0 = state["params"]
    moved_m, moved_a = sm["params"] != p0, sa["params"] != p0
    assert int((moved_m ^ moved_a).sum()) <= 2
    both = moved_m & moved_a
    torch.testing.assert_close(sm["params"][both], sa["params"][both], rtol=0, atol=1e-6)
    for k in sm["mode_state"]:
        torch.testing.assert_close(sm["mode_state"][k], sa["mode_state"][k], rtol=0,
                                   atol=1e-6)
    for k in sm["net_state"]:
        torch.testing.assert_close(sm["net_state"][k], sa["net_state"][k], rtol=1e-5,
                                   atol=1e-6)
    for k in mm:
        torch.testing.assert_close(mm[k], ma[k], rtol=1e-5, atol=0)
    assert mm["participants"].item() == 4


@pytest.mark.parametrize("eng_kw", [{}, {"dp_clip": 1.0}], ids=["plain", "dp_clip"])
def test_masked_client_garbage_is_inert(eng_kw):
    """A dead client's rows do not matter: NaN behind a zero validity gives
    the round a zeroed batch does (the clip must not leak a NaN norm)."""
    step, state, batch = _resnet(3, SKETCH_FULL, on_nonfinite="skip", **eng_kw)
    batch["_valid"] = torch.tensor([1.0, 0.0, 1.0])
    zeroed = dict(batch, x=batch["x"].clone())
    zeroed["x"][1] = 0.0
    poisoned = dict(batch, x=batch["x"].clone())
    poisoned["x"][1] = float("nan")
    a, b = step(state, zeroed, {}, 0.1), step(state, poisoned, {}, 0.1)
    _assert_rounds_equal(a, b)
    assert a[2]["nonfinite_rounds"].item() == 0 and a[2]["participants"].item() == 2


# --------------------------------------------- the session and the loop


def test_degraded_load_is_a_fully_masked_round_whose_cohort_is_queued(tiny_cv, capsys):
    """A load failing past its retries: the round trains on nothing (zero
    validity, participants 0, no uplink), its cohort is queued and served
    by the next round, and stderr says so."""
    s, _ = tcv.build(_args(("--fault_plan", "data_fail@0:times=9", "--max_retries", "0",
                            "--num_workers", "4")))
    p0 = s.state["params"].clone()
    prep = s.prepare_round(0)
    assert "degrading to a fully-masked cohort" in capsys.readouterr().err
    W = len(prep.ids)
    assert prep.masked == W and prep.requeue == tuple(int(i) for i in prep.ids)
    assert not prep.batch["_valid"].any()
    empty = s.train_set.empty_batch(W, s.local_batch_size)
    for k, v in empty.items():
        np.testing.assert_array_equal(prep.batch[k].numpy(), v)
    m = s.commit_round(s.dispatch_round(prep, LR))[0]
    assert (m["participants"], m["clients_dropped"], m["requeue_depth"]) == (0, W, W)
    assert m["comm_up_mb"] == 0.0 and m["comm_down_mb"] > 0
    assert torch.equal(s.state["params"], p0)  # momentum was zero: nothing moved
    assert s._requeue_committed == prep.requeue
    # the next round serves the whole queue. (As in the reference, a queued
    # id sampled anyway counts as served, and a later queued id may take its
    # slot: that client then waits for a fresh draw.)
    nxt = s.prepare_round(1)
    assert nxt.requeue == () and set(nxt.ids) & set(prep.ids)


PLAN = ("client_drop@1:clients=0+3;client_straggle@2:clients=1,secs=0.01;"
        "client_poison@2:clients=2,value=nan;data_fail@3:times=9;client_drop@4:clients=1")
COHORT = ("--num_workers", "4", "--max_retries", "0", "--fault_plan", PLAN)


@pytest.mark.parametrize("extra", [(), ("--client_dropout", "0.25", "--dp_clip", "5.0",
                                        "--requeue_policy", "aged")],
                         ids=["faults", "faults_dropout_clip_aged"])
def test_async_loop_bit_identical_to_sync_with_cohort_faults(tiny_cv, tmp_path, extra):
    argv = (*COHORT, "--num_rounds", "6", "--mode", "sketch", "--k", "100", "--num_cols",
            "2000", "--num_rows", "3", *extra)
    a = tcv.main(_argv((*argv, "--sync_loop", "--log_jsonl", str(tmp_path / "a.jsonl"))))
    b = tcv.main(_argv((*argv, "--log_jsonl", str(tmp_path / "b.jsonl"))))
    _assert_state_equal(a, b)
    ra, rb = _rows(tmp_path / "a.jsonl"), _rows(tmp_path / "b.jsonl")
    assert [{k: v for k, v in r.items() if k != "time_s"} for r in ra] == \
        [{k: v for k, v in r.items() if k != "time_s"} for r in rb]
    if not extra:  # with dropout the poisoned client may have dropped out
        assert ra[-1]["nonfinite_rounds"] == 1
    assert a._requeue_committed == b._requeue_committed
    assert a._requeue_ages_committed == b._requeue_ages_committed
    assert a.run_stats.clients_dropped == b.run_stats.clients_dropped >= 2 + 4 + 1
    assert a.run_stats.requeue_depth_max == b.run_stats.requeue_depth_max == 4


@pytest.mark.parametrize("policy", ["fifo", "aged"])
def test_preempt_resume_with_a_queue_bit_identical(tiny_cv, tmp_path, policy):
    """preempt@2 after drops at rounds 1 and 2: the emergency checkpoint
    (round 3) holds a non-empty committed queue with its ages in
    meta.json, and the resumed run lands bitwise on the uninterrupted
    one, queue and ages included."""
    plan = "client_drop@1:clients=0+1;client_drop@2:clients=0+3"
    argv = ("--num_workers", "4", "--num_rounds", "5", "--requeue_policy", policy,
            "--client_dropout", "0.2", "--fault_plan", plan)
    ref = tcv.main(_argv(argv))
    argv = (*argv[:-1], plan + ";preempt@2")
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as ei:
        tcv.main(_argv((*argv, "--checkpoint_dir", ck)))
    assert ei.value.code == EXIT_RESUMABLE
    path = ckpt.latest(ck)
    assert path.endswith("round_00000003")
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert len(meta["requeued"]) == 2 and meta["requeue_ages"] == \
        [[c, 2] for c in meta["requeued"]]
    resumed = tcv.main(_argv((*argv, "--checkpoint_dir", ck, "--resume")))
    assert resumed.run_stats.rounds == 2
    _assert_state_equal(ref, resumed)
    assert resumed._requeue_committed == ref._requeue_committed
    assert resumed._requeue_ages_committed == ref._requeue_ages_committed


def test_one_shot_drop_refires_only_in_a_run_resumed_before_it(tiny_cv, tmp_path, capsys):
    """``_fired`` lives in the process and rounds are global: a run
    resumed at round 0 drops round 1's clients again, one resumed at
    round 2 does not; both land on the uninterrupted run."""
    argv = ("--num_workers", "4", "--num_rounds", "4", "--fault_plan",
            "client_drop@1:clients=2")
    ref = tcv.main(_argv(argv))
    capsys.readouterr()
    ck0 = str(tmp_path / "ck0")
    s, _ = tcv.build(_args(argv))
    ckpt.save(ck0, s)
    at0 = tcv.main(_argv((*argv, "--checkpoint_dir", ck0, "--resume")))
    assert "dropping clients [2] (round 1" in capsys.readouterr().err
    _assert_state_equal(ref, at0)
    ck2 = str(tmp_path / "ck2")
    with pytest.raises(SystemExit):
        tcv.main(_argv((*argv, "--checkpoint_dir", ck2, "--fault_plan",
                        "client_drop@1:clients=2;preempt@1")))
    assert ckpt.latest(ck2).endswith("round_00000002")
    capsys.readouterr()
    at2 = tcv.main(_argv((*argv, "--checkpoint_dir", ck2, "--resume")))
    assert "dropping clients" not in capsys.readouterr().err
    _assert_state_equal(ref, at2)


def test_loop_exit_rolls_the_live_queue_back_to_the_committed_one(tiny_cv):
    """The prefetcher may prepare (and so drop and queue) rounds past the
    run's end; the exit rollback puts the live queue and its ages back to
    the committed snapshot, so a reused session never holds a doubly
    queued id."""
    from commefficient_tpu_torch.federated.api import FedOptimizer
    from commefficient_tpu_torch.runner import RunnerConfig, run_loop

    s, _ = tcv.build(_args(("--num_workers", "4", "--fault_plan",
                            "client_drop@2:clients=0+1;client_drop@3:clients=1")))
    opt = FedOptimizer(lambda e: LR, 4)
    run_loop(s, opt, RunnerConfig(total_rounds=2, eval_every=2, prefetch_depth=3))
    assert tuple(s._requeue) == s._requeue_committed == ()
    assert s._requeue_enqueued == {}
    run_loop(s, opt, RunnerConfig(total_rounds=5, eval_every=5))
    q = list(s._requeue_committed)
    assert len(q) == len(set(q))


def test_unknown_requeue_policy_is_refused(tiny_cv):
    args = _args()
    args.requeue_policy = "lifo"  # past argparse's choices, as an API caller could
    with pytest.raises(ValueError, match="requeue_policy must be 'fifo' or 'aged'"):
        tcv.build(args)
