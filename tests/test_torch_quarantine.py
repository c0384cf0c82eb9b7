"""The sketch-space quarantine in the port (--client_update_clip, its
baseline window and layer scope), held against the JAX package
(tests/test_cohort_faults.py and tests/test_byzantine.py's single-device
cases).

Tolerances. The primitives on equal float32 inputs (median, masks, ring
advances at window 1 and 4, the per-leaf rings): exact. The norms
themselves are float32 reductions that the two packages associate in
their own orders: within rtol 1e-6. Fused rounds with the clip armed
against the reference's single-device round (sketch, uncompressed,
local_topk): per-round counts exact, the running median within rtol 1e-5,
params within atol 1e-5 (tests/test_torch_round.py's tolerance). Within
the port, bitwise: a quarantined client is the masked client, the verdict
is the same at every client chunk, a resumed run is the uninterrupted
one, rings included."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.obs import trace as obtrace
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.utils import checkpoint as ckpt
from test_torch_byzantine import ATOL, LR, _jsession, _quad_paths, _run, _tsession  # noqa: F401
from test_torch_runner import _argv, _rows, tiny_cv  # noqa: F401
from test_torch_serve import SKETCH, UNCOMPRESSED, _jparams, _tparams

torch.set_num_threads(2)

LOCAL = dict(mode="local_topk", k=4, momentum=0.9, momentum_type="local", error_type="local",
             num_clients=12)


def _cfgs(**kw):
    mc = dict(mode="sketch", d=100, k=4, num_rows=2, num_cols=16)
    return (tengine.EngineConfig(mode=TModeConfig(**mc), **kw),
            jengine.EngineConfig(mode=JModeConfig(**mc), **kw))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ----------------------------------------------------- the primitives

@pytest.mark.parametrize("seed", range(4))
def test_masked_median_and_mask_match_reference(seed):
    rs = np.random.RandomState(seed)
    W = 8
    values = rs.rand(W).astype(np.float32) * 10
    values[rs.rand(W) < 0.2] = np.nan
    live = rs.rand(W) < 0.7
    n = int((live & np.isfinite(values)).sum())
    tcfg, jcfg = _cfgs(client_update_clip=1.5)
    tl = torch.from_numpy(live & np.isfinite(values))
    got = tengine._masked_median(torch.from_numpy(values), tl, torch.tensor(n))
    want = jengine._masked_median(jnp.asarray(values), jnp.asarray(live & np.isfinite(values)),
                                  jnp.asarray(n))
    if n:
        assert got.item() == float(want)
    part = live.astype(np.float32)
    tm, tn = tengine._round_median(torch.from_numpy(values), torch.from_numpy(part))
    jm, jn = jengine._round_median(jnp.asarray(values), jnp.asarray(part))
    assert int(tn) == int(jn) == n and (not n or tm.item() == float(jm))
    for qmed in (0.0, 2.0, float(np.nanmedian(values))):
        np.testing.assert_array_equal(
            tengine._quarantine_mask(tcfg, torch.from_numpy(values), torch.tensor(qmed)).numpy(),
            np.asarray(jengine._quarantine_mask(jcfg, jnp.asarray(values), jnp.float32(qmed))))


@pytest.mark.parametrize("window", [1, 4])
def test_advance_quarantine_matches_reference(window):
    """Seven rounds of one ring, an empty round and a non-finite cohort
    among them: the same state tree and the same values, exactly."""
    tcfg, jcfg = _cfgs(client_update_clip=3.0, quarantine_window=window)
    rs = np.random.RandomState(0)
    tq = {"median": torch.zeros(())}
    jq = {"median": jnp.zeros(())}
    if window > 1:
        tq.update(window=torch.zeros(window), count=torch.zeros((), dtype=torch.int32))
        jq.update(window=jnp.zeros(window), count=jnp.zeros((), jnp.int32))
    for r in range(7):
        norms = (rs.rand(6) * (r + 1)).astype(np.float32)
        part = (rs.rand(6) < 0.8).astype(np.float32)
        if r == 3:
            part[:] = 0.0  # an empty round: nothing pushed, the threshold kept
        if r == 5:
            norms[:] = np.inf
        tq = tengine._advance_quarantine(tcfg, tq, torch.from_numpy(norms),
                                         torch.from_numpy(part))
        jq = jengine._advance_quarantine(jcfg, jq, jnp.asarray(norms), jnp.asarray(part))
        assert tq.keys() == jq.keys()
        for k in tq:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]), err_msg=(r, k))
            assert tq[k].numpy().dtype == np.asarray(jq[k]).dtype, k


@pytest.mark.parametrize("window", [1, 3])
def test_layer_rings_match_reference(window):
    tcfg, jcfg = _cfgs(client_update_clip=2.0, quarantine_scope="layer",
                       quarantine_window=window)
    L, W = 3, 5
    rs = np.random.RandomState(1)
    tq = {"layer_median": torch.zeros(L)}
    jq = {"layer_median": jnp.zeros(L)}
    if window > 1:
        tq.update(layer_window=torch.zeros(L, window),
                  layer_count=torch.zeros(L, dtype=torch.int32))
        jq.update(layer_window=jnp.zeros((L, window)), layer_count=jnp.zeros(L, jnp.int32))
    singles = [{k[len("layer_"):]: v[leaf] for k, v in tq.items()} for leaf in range(L)]
    for r in range(5):
        lnorms = (rs.rand(W, L) + 0.5).astype(np.float32)
        part = np.array([1, 1, 0, 1, 1], np.float32)
        tq = tengine._advance_quarantine_layers(tcfg, tq, torch.from_numpy(lnorms),
                                                torch.from_numpy(part))
        jq = jengine._advance_quarantine_layers(jcfg, jq, jnp.asarray(lnorms), jnp.asarray(part))
        for k in tq:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]), err_msg=(r, k))
        lmed = tq["layer_median"]
        np.testing.assert_array_equal(
            tengine._quarantine_layer_mask(tcfg, torch.from_numpy(lnorms * 3), lmed).numpy(),
            np.asarray(jengine._quarantine_layer_mask(jcfg, jnp.asarray(lnorms * 3),
                                                      jnp.asarray(lmed.numpy()))))
        # each leaf's ring is the scalar ring on that leaf's norms
        for leaf in range(L):
            singles[leaf] = tengine._advance_quarantine(
                tcfg, singles[leaf], torch.from_numpy(lnorms[:, leaf]), torch.from_numpy(part))
            for k, v in singles[leaf].items():
                assert torch.equal(v, tq[f"layer_{k}"][leaf]), (r, leaf, k)


def test_layer_mask_catches_what_the_flat_norm_dilutes():
    tcfg, _ = _cfgs(client_update_clip=2.0, quarantine_scope="layer")
    norms = torch.tensor([10.0, 10.2])
    lnorms = torch.tensor([[10.0, 0.1], [10.0, 2.0]])
    assert not tengine._quarantine_mask(tcfg, norms, torch.tensor(10.0))[1]
    assert tengine._quarantine_layer_mask(tcfg, lnorms, torch.tensor([10.0, 0.1])).tolist() == \
        [False, True]


def test_norms_and_adversarial_transform_match_reference():
    rs = np.random.RandomState(2)
    u = rs.randn(5, 40).astype(np.float32) * 3
    segs = ((0, 7), (7, 30), (37, 3))
    np.testing.assert_allclose(tengine._client_norms(torch.from_numpy(u)).numpy(),
                               np.asarray(jengine._client_norms(jnp.asarray(u))), rtol=1e-6)
    np.testing.assert_allclose(tengine._client_layer_norms(torch.from_numpy(u), segs).numpy(),
                               np.asarray(jengine._client_layer_norms(jnp.asarray(u), segs)),
                               rtol=1e-6)
    # one leaf spanning the update: the cohort screen's reduction exactly
    assert torch.equal(tengine._client_layer_norms(torch.from_numpy(u), ((0, 40),))[:, 0],
                       tengine._client_norms(torch.from_numpy(u)))
    tables = rs.randn(5, 3, 8).astype(np.float32)
    np.testing.assert_allclose(tengine._table_norms(torch.from_numpy(tables)).numpy(),
                               np.asarray(jengine._table_norms(jnp.asarray(tables))), rtol=1e-6)
    scale = np.array([1, -1, 50, -1, 1], np.float32)
    src = np.array([0, 1, 2, 0, 4], np.int32)
    ride = np.array([0, 0, 0, 0, 0.9], np.float32)
    for adv, qmed in (((scale, src, None), None), ((scale, src, ride), 2.0),
                      ((scale, src, ride), 0.0)):
        t = tengine._apply_adv(torch.from_numpy(tables), tuple(
            None if a is None else torch.from_numpy(a) for a in adv), 3.0,
            None if qmed is None else torch.tensor(qmed))
        j = jengine._apply_adv(jnp.asarray(tables), tuple(
            None if a is None else jnp.asarray(a) for a in adv), 3.0,
            None if qmed is None else jnp.float32(qmed))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
        if adv[2] is None:  # the gather and the multiply are exact
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        elif qmed:
            assert tengine._table_norms(t)[4].item() == pytest.approx(0.9 * 3.0 * qmed,
                                                                     rel=1e-6)
    ident = (torch.ones(5), torch.arange(5, dtype=torch.int32), None)
    assert torch.equal(tengine._apply_adv(torch.from_numpy(tables), ident),
                       torch.from_numpy(tables))


def test_quarantine_validation_and_state_tree():
    mc = TModeConfig(mode="sketch", d=21, k=4, num_rows=3, num_cols=8)
    with pytest.raises(ValueError, match="client_update_clip"):
        tengine.EngineConfig(mode=mc, quarantine_scope="layer")
    with pytest.raises(ValueError, match="client_update_clip must be"):
        tengine.EngineConfig(mode=mc, client_update_clip=-1.0)
    with pytest.raises(ValueError, match="quarantine_window must be"):
        tengine.EngineConfig(mode=mc, quarantine_window=0)
    with pytest.raises(ValueError, match="quarantine_scope must be"):
        tengine.EngineConfig(mode=mc, quarantine_scope="leaf", client_update_clip=1.0)
    for kw, keys in (({}, None), ({"client_update_clip": 3.0}, {"median"}),
                     ({"client_update_clip": 3.0, "quarantine_window": 4},
                      {"median", "window", "count"}),
                     ({"client_update_clip": 3.0, "quarantine_scope": "layer"},
                      {"median", "layer_median"}),
                     ({"client_update_clip": 3.0, "quarantine_scope": "layer",
                       "quarantine_window": 2},
                      {"median", "window", "count", "layer_median", "layer_window",
                       "layer_count"})):
        t, j = _tsession(**kw), _jsession(**kw)
        assert (set(t.state["quarantine"]) if keys else None) == keys
        if keys:
            jq = _np(j.state["quarantine"])
            assert jq.keys() == t.state["quarantine"].keys()
            for k, v in t.state["quarantine"].items():
                assert (tuple(v.shape), v.numpy().dtype) == (jq[k].shape, jq[k].dtype), k
        else:
            assert "quarantine" not in t.state


# ------------------------------------------- fused rounds, both packages

@pytest.mark.parametrize("mode", ["sketch", "uncompressed", "local_topk"])
@pytest.mark.parametrize("extra", [{}, {"quarantine_window": 3, "quarantine_scope": "layer"}])
def test_fused_round_with_clip_matches_reference(mode, extra):
    """A poisoned (1e6-scaled) client at round 2 of the fused round: the
    same verdicts, the same median, params within ATOL."""
    m = {"sketch": SKETCH, "uncompressed": UNCOMPRESSED, "local_topk": LOCAL}[mode]
    plan = "client_poison@2:clients=1,value=big;client_poison@3:clients=0,value=nan"
    kw = dict(client_update_clip=3.0, **extra)
    j, t = _jsession(plan, mode=m, **kw), _tsession(plan, mode=m, **kw)
    assert not t._table_round
    mj, mt = _run(j, 4), _run(t, 4)
    assert [x["clients_quarantined"] for x in mt] == [x["clients_quarantined"] for x in mj] \
        == [0.0, 0.0, 1.0, 1.0]
    for a, b in zip(mj, mt):
        assert a["participants"] == b["participants"]
        assert b["quarantine_median"] == pytest.approx(a["quarantine_median"], rel=1e-5)
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)
    jq = _np(j.state["quarantine"])
    for k, v in t.state["quarantine"].items():
        np.testing.assert_allclose(v.numpy(), jq[k], rtol=1e-5, err_msg=k)
    if mode == "local_topk":
        # the rejected clients' rows never saw the poison
        assert all(torch.isfinite(v).all() for v in t.client_state.values())


def test_table_round_with_clip_and_layers_matches_reference():
    plan = "client_scale@2:clients=1,factor=50"
    kw = dict(client_update_clip=3.0, quarantine_window=2, quarantine_scope="layer",
              wire_payloads=True)
    j, t = _jsession(plan, **kw), _tsession(plan, **kw)
    mj, mt = _run(j, 4), _run(t, 4)
    assert [x["clients_quarantined"] for x in mt] == [x["clients_quarantined"] for x in mj]
    assert sum(x["clients_quarantined"] for x in mt) == 1.0
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)
    assert t.state["quarantine"]["layer_median"].shape == (2,)


# -------------------------------------------------- within the port

def test_quarantine_is_the_masked_client_bitwise():
    """client_chunk 1: the round with a 1e6-poisoned client quarantined is
    bitwise the round whose validity mask kills that client."""
    a = _tsession("client_poison@1:clients=2,value=big", workers=8, client_update_clip=3.0,
                  client_chunk=1)
    b = _tsession("client_drop@1:clients=2", workers=8, client_update_clip=3.0,
                  client_chunk=1)
    ma, mb = _run(a, 2), _run(b, 2)
    assert (ma[1]["clients_quarantined"], mb[1]["clients_quarantined"]) == (1.0, 0.0)
    assert ma[1]["participants"] == mb[1]["participants"] == 7.0
    assert ma[1]["loss_sum"] == mb[1]["loss_sum"]
    assert np.array_equal(_tparams(a), _tparams(b))
    assert torch.equal(a.state["quarantine"]["median"], b.state["quarantine"]["median"])


def test_verdict_is_the_same_at_every_client_chunk():
    plan = "client_poison@1:clients=2,value=big;client_poison@2:clients=5+6,value=big"
    counts = {}
    for chunk in (0, 4, 1):
        s = _tsession(plan, workers=8, client_update_clip=3.0, quarantine_scope="layer",
                      client_chunk=chunk)
        counts[chunk] = [m["clients_quarantined"] for m in _run(s, 3)]
    assert counts[0] == counts[4] == counts[1] == [0.0, 1.0, 2.0]


def test_clean_run_quarantines_nothing():
    a, b = _tsession(), _tsession(client_update_clip=3.0, quarantine_window=2)
    ma, mb = _run(a, 3), _run(b, 3)
    assert all(m["clients_quarantined"] == 0.0 for m in mb)
    assert np.array_equal(_tparams(a), _tparams(b))
    assert [{k: v for k, v in m.items() if "quarantine" not in k} for m in mb] == ma


def test_quarantine_counts_reach_the_run_loop(tiny_cv):
    """RunStats, the registry counter and the resilience trace instant; a
    quarantined client stays charged for its uplink."""
    reg = obreg.default()
    mark = reg.mark()
    events = []
    tracer = obtrace.get()
    orig = tracer.instant
    tracer.instant = lambda track, name, **a: (events.append((track, name, a)),
                                               orig(track, name, **a))[1]
    try:
        s = cv_train.main(_argv(("--num_rounds", "3", "--sync_loop", "--num_workers", "4",
                                 "--client_update_clip", "3",
                                 "--fault_plan", "client_poison@1:clients=2,value=big")))
    finally:
        tracer.instant = orig
    assert s.run_stats.clients_quarantined == 1 == s.clients_quarantined_total
    assert mark.delta("cohort_clients_quarantined_total") == 1.0
    assert ("resilience", "quarantine", {"round": 1, "clients": 1}) in events
    assert s.run_stats.attacks_injected == 0


# ----------------------------------------------- checkpoints and the CLI

QUARANTINE_FLAGS = ("--client_update_clip", "3", "--quarantine_window", "4",
                    "--quarantine_scope", "layer")


def test_resume_equals_uninterrupted_rings_included(tiny_cv, tmp_path):
    plan = "client_poison@1:clients=0,value=big"
    base = _argv(("--num_rounds", "5", "--eval_every", "5", "--num_workers", "4",
                  *QUARANTINE_FLAGS))
    full = cv_train.main(base + ["--fault_plan", plan, "--log_jsonl", str(tmp_path / "a.jsonl")])
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as ei:
        cv_train.main(base + ["--fault_plan", plan + ";preempt@2", "--checkpoint_dir", ck])
    assert ei.value.code == EXIT_RESUMABLE
    path = ckpt.latest(ck)
    assert torch.load(os.path.join(path, "state.pt"), weights_only=True)["quarantine"].keys() \
        == full.state["quarantine"].keys()
    res = cv_train.main(base + ["--fault_plan", plan + ";preempt@2", "--checkpoint_dir", ck,
                                "--resume", "--log_jsonl", str(tmp_path / "b.jsonl")])
    assert res.round == full.round == 5
    assert torch.equal(res.state["params"], full.state["params"])
    for k, v in full.state["quarantine"].items():
        assert torch.equal(res.state["quarantine"][k], v), k
    assert int(full.state["quarantine"]["count"]) == 4
    keys = ("round", "test_loss", "test_acc", "comm_mb")
    assert [{k: r[k] for k in keys} for r in _rows(tmp_path / "b.jsonl")] == \
        [{k: r[k] for k in keys} for r in _rows(tmp_path / "a.jsonl")]


def test_checkpoint_of_another_quarantine_tree_is_refused(tiny_cv, tmp_path):
    ck = str(tmp_path / "ck")
    cv_train.main(_argv(("--num_rounds", "1", "--client_update_clip", "3",
                         "--checkpoint_dir", ck)))
    with pytest.raises(ckpt.CheckpointMismatchError, match="quarantine"):
        cv_train.main(_argv(("--num_rounds", "2", *QUARANTINE_FLAGS, "--checkpoint_dir", ck,
                             "--resume")))
    with pytest.raises(ckpt.CheckpointMismatchError, match="quarantine"):
        cv_train.main(_argv(("--num_rounds", "2", "--checkpoint_dir", ck, "--resume")))
    assert not [d for d in os.listdir(ck) if d.endswith(".damaged")]


@pytest.mark.parametrize("flags", [
    ("--client_update_clip", "3"),
    QUARANTINE_FLAGS,
    ("--merge_policy", "trimmed", "--merge_trim", "1"),
    ("--merge_policy", "median", "--robust_residual", "on", "--client_update_clip", "3",
     "--fault_plan", "client_signflip@1:clients=0;client_normride@2:clients=1,ride=0.5"),
    ("--merge_policy", "trimmed", "--merge_trim", "0", "--fault_plan",
     "seed=1;client_collude@1:frac=0.5;client_scale@2:clients=0,factor=20"),
])
def test_cli_runs_the_six_flags(tiny_cv, tmp_path, flags):
    """The flags end to end through ``cv_train.main`` on the CPU, the async
    loop bitwise the sync loop."""
    base = _argv(("--num_rounds", "3", "--eval_every", "3", "--num_workers", "4", *flags),
                 mode="sketch")
    a = cv_train.main(base + ["--sync_loop", "--log_jsonl", str(tmp_path / "s.jsonl")])
    b = cv_train.main(base + ["--log_jsonl", str(tmp_path / "a.jsonl")])
    assert a.round == 3 and np.isfinite(a.state["params"].numpy()).all()
    assert torch.equal(a.state["params"], b.state["params"])
    assert _rows(tmp_path / "s.jsonl") == _rows(tmp_path / "a.jsonl")
    robust = "--merge_trim" in flags and flags[flags.index("--merge_trim") + 1] != "0"
    assert a._table_round == (robust or "median" in flags or "--fault_plan" in flags)
    assert a.cfg.client_update_clip == (3.0 if "--client_update_clip" in flags else 0.0)


def test_cli_refuses_residual_without_a_robust_merge():
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    for extra in ([], ["--merge_policy", "trimmed"]):
        with pytest.raises(SystemExit, match="robust_residual"):
            resolve_defaults(make_parser().parse_args(["--robust_residual", "on", *extra]))
    args = resolve_defaults(make_parser().parse_args(
        ["--robust_residual", "on", "--merge_policy", "trimmed", "--merge_trim", "1"]))
    assert args.robust_residual == "on"


def test_served_payload_arms_the_gauntlet(tiny_cv, tmp_path, monkeypatch):
    """--serve_payload sketch with the clip: the gauntlet's policy reads the
    session's ring, a 50x-scaled table is QUARANTINED at the wire, and the
    status shows the defence."""
    services = []
    build = cv_train.service_from_args
    monkeypatch.setattr(cv_train, "service_from_args",
                        lambda args, session: services.append(build(args, session))
                        or services[-1])
    s = cv_train.main(_argv(("--num_rounds", "3", "--num_workers", "4", "--serve", "inproc",
                             "--serve_payload", "sketch", "--serve_quorum", "4",
                             "--serve_deadline", "30", "--sync_loop", "--client_update_clip",
                             "3", "--merge_policy", "median",
                             "--fault_plan", "client_scale@2:clients=1,factor=50"),
                            mode="sketch"))
    assert s.round == 3 and np.isfinite(s.state["params"].numpy()).all()
    svc = services[0]
    policy = svc.queue.payload_policy
    assert policy.clip_multiple == 3.0
    assert policy.quarantine_median() == float(s.state["quarantine"]["median"]) > 0.0
    assert svc.queue.counters()["rejected_quarantined"] == 1
    snap = svc.metrics_snapshot()
    assert (snap["merge_policy"], snap["merge_trim"], snap["quarantine_scope"]) == \
        ("median", 0, "cohort")
    assert snap["clients_quarantined"] == s.clients_quarantined_total == 0
