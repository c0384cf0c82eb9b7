"""Byzantine-robust merges and the adversarial fault kinds in the port,
held against the JAX package (tests/test_byzantine.py and
tests/test_async_robust.py's single-device cases).

Tolerances. The robust merge on the same float32 stack: the median
bitwise (a sort is exact and both take 0.5 * (lo + hi)); the trimmed mean
and the winsorized residual bitwise as well on these inputs (the port sums
the survivors by ``csvec.merge_tables``' ordered fold, the reference by
XLA's reduce: on the CPU both add the rows in client order). The
adversarial and norm-ride plans: equal position for position. Whole table
rounds against the reference's single-device rounds, on
tests/test_byzantine.py's quad-loss model: per-round counts exact, params
within atol 1e-5 (the two packages sum a client's gradient, and so its
table, in another float order: tests/test_torch_serve.py's tolerance).
Within the port, bitwise: trimmed with trim 0 is the sum, a quarantined
payload is the dropped client, a wire rejection is the merge's quarantine,
and a block of rounds is the rounds one by one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.data.fed_dataset import FedDataset as JFedDataset
from commefficient_tpu.data.fed_dataset import shard_iid as jshard_iid
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.federated.api import FederatedSession as JSession
from commefficient_tpu.modes import modes as jmodes
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu.resilience import FaultPlan as JFaultPlan
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.serve.ingest import (ACCEPTED, QUARANTINED, PayloadPolicy,
                                                  validate_payload)
from test_torch_serve import DIN, DOUT, SKETCH, _data, _jparams, _jquad, _Quad, _tparams, _tquad

torch.set_num_threads(2)

LR = 0.05
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _quad_paths(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", {"w": ("w",), "b": ("b",)}.__getitem__)


def _jsession(plan=None, workers=4, mode=SKETCH, **kw):
    x, y, w0 = _data()
    train = JFedDataset(x, y, jshard_iid(len(x), 12, np.random.RandomState(1)))
    params = {"w": jnp.asarray(w0), "b": jnp.zeros(DOUT)}
    return JSession(train_loss_fn=_jquad, eval_loss_fn=_jquad, params=params, net_state={},
                    mode_cfg=JModeConfig(d=ravel_pytree(params)[0].size, **mode),
                    train_set=train, num_workers=workers, local_batch_size=4, seed=0,
                    fault_plan=JFaultPlan.parse(plan), **kw)


def _tsession(plan=None, workers=4, mode=SKETCH, **kw):
    x, y, w0 = _data()
    train = TFedDataset(x, y, tshard_iid(len(x), 12, np.random.RandomState(1)))
    model = _Quad(w0)
    layout = convert.FlatLayout(model)
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(model.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(d=layout.d, **mode), train_set=train,
                    num_workers=workers, local_batch_size=4, seed=0,
                    fault_plan=TFaultPlan.parse(plan), device="cpu", **kw)


def _run(session, n=4, lr=LR):
    return [session.run_round(lr) for _ in range(n)]


def _spec(shape):
    W, r, c = shape
    return TModeConfig(mode="sketch", d=4 * c, k=2, num_rows=r, num_cols=c).sketch_spec


def _both(tables, live, policy, trim, **kw):
    """(port, reference) robust merges of one numpy stack."""
    t = tmodes._robust_table_merge(_spec(tables.shape), torch.from_numpy(tables),
                                   torch.from_numpy(live), policy, trim, **kw)
    j = jmodes._robust_table_merge(jnp.asarray(tables), jnp.asarray(live), policy, trim, **kw)
    return t, j


# ------------------------------------------------- the merge, unit level

def _stack(case):
    rs = np.random.RandomState(3)
    tables = rs.randn(7, 3, 5).astype(np.float32)
    live = np.ones(7, np.float32)
    if case == "dead":
        live[[1, 4]] = 0.0
        tables[1] = np.nan  # a dead row's payload never reaches the statistic
    elif case == "nonfinite":
        tables[2, 1, 3] = np.nan
        tables[5, 0, 0] = np.inf
    elif case == "ties":
        tables = rs.randint(-2, 3, (7, 3, 5)).astype(np.float32)
    elif case == "degraded":
        live[2:] = 0.0  # 2 live rows: below 2 * trim + 1 for trim 1
    return tables, live


CASES = ["all_live", "dead", "nonfinite", "ties", "degraded"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("policy,trim", [("median", 0), ("trimmed", 1), ("trimmed", 2)])
def test_robust_merge_matches_reference(case, policy, trim):
    tables, live = _stack(case)
    if case == "degraded" and policy == "median":
        live[1] = 0.0  # one live row: its own median
    t, j = _both(tables, live, policy, trim)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if case == "degraded" and policy == "trimmed":
        assert not t.any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("policy,trim", [("median", 0), ("trimmed", 1)])
def test_robust_residual_matches_reference(case, policy, trim):
    tables, live = _stack(case)
    (tr, tw, tx), (jr, jw, jx) = _both(tables, live, policy, trim, want_residual=True)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert float(tw) == float(jw)
    np.testing.assert_array_equal(tx["residual"].numpy(), np.asarray(jx["residual"]))
    # the residual form's robust value is the plain form's
    np.testing.assert_array_equal(tr.numpy(), _both(tables, live, policy, trim)[0].numpy())


def test_trimmed_tie_break_is_by_client_index():
    tables = np.array([[[1.0]], [[1.0]], [[1.0]], [[5.0]]], np.float32)
    t, j = _both(tables, np.ones(4, np.float32), "trimmed", 1)
    np.testing.assert_array_equal(t.numpy(), np.array([[1.0]], np.float32))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("W,trim", [(3, 1), (8, 1), (8, 3), (32, 0), (32, 5), (100, 2)])
def test_trimmed_keep_is_the_stable_rank_window(W, trim):
    """The keep mask read off the sorted values equals ranks [trim, n - trim)
    of a stable argsort (ties by row index), with dead rows keyed past the
    live ones: heavy ties, signed zeros, and live counts on both sides of
    2 * trim + 1."""
    rs = np.random.RandomState(W + trim)
    vals = rs.randint(-2, 3, (W, 4, 6)).astype(np.float32)
    vals[vals == 0] = rs.choice(np.array([0.0, -0.0], np.float32), (vals == 0).sum())
    for n_live in sorted({W, max(W - 3, 1), 2 * trim + 1, 2 * trim} & set(range(1, W + 1))):
        live = np.zeros(W, bool)
        live[rs.permutation(W)[:n_live]] = True
        keyed = np.where(live[:, None, None], vals, np.float32(np.inf))
        order = np.argsort(keyed, axis=0, kind="stable")
        ranks = np.empty_like(order)
        np.put_along_axis(ranks, order, np.arange(W)[:, None, None], axis=0)
        want = (ranks >= trim) & (ranks < n_live - trim) & live[:, None, None]
        kt = torch.from_numpy(keyed)
        got = tmodes._trimmed_keep(kt, torch.sort(kt, dim=0).values, torch.tensor(n_live),
                                   trim) & torch.from_numpy(live)[:, None, None]
        np.testing.assert_array_equal(got.numpy(), want)


def test_robust_merge_excludes_dead_and_nonfinite_rows():
    tables = np.array([[[10.0]], [[-100.0]], [[12.0]], [[14.0]]], np.float32)
    t, _ = _both(tables, np.array([1, 0, 1, 1], np.float32), "median", 0)
    np.testing.assert_array_equal(t.numpy(), np.array([[12.0]], np.float32))
    # a live NaN row burns no slot of the trim budget
    tables = np.array([[[np.nan]], [[1.0]], [[2.0]], [[3.0]], [[100.0]]], np.float32)
    for policy, trim in (("trimmed", 1), ("median", 0)):
        t, j = _both(tables, np.ones(5, np.float32), policy, trim)
        np.testing.assert_array_equal(t.numpy(), np.array([[2.5]], np.float32))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_residual_is_winsorized_and_bounded():
    honest = np.linspace(-1.0, 1.0, 5, dtype=np.float32).reshape(5, 1, 1)
    attacked = honest.copy()
    attacked[0] = 1e6
    live = np.ones(5, np.float32)
    r_h = float(_both(honest, live, "trimmed", 1, want_residual=True)[0][2]["residual"])
    (_, _, ex), (_, _, jex) = _both(attacked, live, "trimmed", 1, want_residual=True)
    r_a = float(ex["residual"])
    assert abs(r_a - r_h) <= 2.0, (r_h, r_a)
    vals = np.sort(attacked.squeeze())
    clamped = np.clip(attacked.squeeze(), vals[1], vals[3])
    assert r_a == pytest.approx(clamped.mean() - vals[1:4].mean(), rel=1e-5)
    assert r_a == float(np.asarray(jex["residual"]).squeeze())


def test_merge_partial_wires_rejects_bad_robust_calls():
    cfg = TModeConfig(mode="uncompressed", d=4, momentum_type="none", error_type="none")
    with pytest.raises(ValueError, match="no table wire"):
        tmodes.merge_partial_wires(cfg, {"dense": torch.zeros(2, 4)}, policy="median",
                                   live=torch.ones(2))
    ltk = TModeConfig(mode="local_topk", d=4, k=2, momentum_type="none", error_type="none")
    with pytest.raises(ValueError, match="nonlinear"):
        tmodes.merge_partial_wires(ltk, {"dense": torch.zeros(2, 4)})
    scfg = TModeConfig(mode="sketch", d=4, k=2, num_rows=2, num_cols=4)
    with pytest.raises(ValueError, match="live-client mask"):
        tmodes.merge_partial_wires(scfg, {"table": torch.zeros(2, 2, 4)}, policy="median")
    with pytest.raises(ValueError, match="trim the whole cohort"):
        tmodes.merge_partial_wires(scfg, {"table": torch.zeros(2, 2, 4)}, policy="trimmed",
                                   live=torch.ones(2), trim=1)
    with pytest.raises(ValueError, match="item 9b"):
        tmodes.merge_partial_wires(scfg, {"table": torch.zeros(3, 2, 4)}, policy="median",
                                   live=torch.ones(3), stale_tables=torch.zeros(1, 2, 4),
                                   stale_weights=torch.ones(1))
    with pytest.raises(ValueError, match="unknown robust merge policy"):
        tmodes._robust_table_merge(scfg.sketch_spec, torch.zeros(3, 2, 4), torch.ones(3),
                                   "mean", 0)
    # the plain forms: the ordered table sum and the dense sum
    tables = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)
    assert torch.equal(tmodes.merge_partial_wires(scfg, {"table": tables})["table"],
                       tables[0] + tables[1] + tables[2])
    assert torch.equal(tmodes.merge_partial_wires(cfg, {"dense": tables[:, 0]})["dense"],
                       tables[:, 0].sum(0))


# --------------------------------------------- config and routing

def test_robust_policy_validation():
    mc = TModeConfig(mode="sketch", d=8, k=2, num_rows=2, num_cols=4)
    unc = TModeConfig(mode="uncompressed", d=8, momentum_type="none", error_type="none")
    with pytest.raises(ValueError, match="mode='sketch'"):
        tengine.EngineConfig(mode=unc, merge_policy="median")
    with pytest.raises(ValueError, match="merge_trim"):
        tengine.EngineConfig(mode=mc, merge_policy="median", merge_trim=1)
    with pytest.raises(ValueError, match="merge_policy must be"):
        tengine.EngineConfig(mode=mc, merge_policy="mean")
    with pytest.raises(ValueError, match="merge_trim must be"):
        tengine.EngineConfig(mode=mc, merge_policy="trimmed", merge_trim=-1)
    for kw in ({}, {"merge_policy": "trimmed", "merge_trim": 0}):
        with pytest.raises(ValueError, match="robust_residual"):
            tengine.EngineConfig(mode=mc, robust_residual=True, **kw)
    assert tengine.EngineConfig(mode=mc, robust_residual=True,
                                merge_policy="median").robust_residual
    # trimmed with trim 0 is the sum: no robust policy, no table round
    for kw, pol in (({"merge_policy": "trimmed", "merge_trim": 0}, None),
                    ({"merge_policy": "trimmed", "merge_trim": 1}, "trimmed"),
                    ({"merge_policy": "median"}, "median")):
        cfg, jcfg = tengine.EngineConfig(mode=mc, **kw), jengine.EngineConfig(
            mode=JModeConfig(mode="sketch", d=8, k=2, num_rows=2, num_cols=4), **kw)
        assert tengine.robust_policy(cfg) == jengine.robust_policy(jcfg) == pol
        assert tengine.uses_table_round(cfg) == jengine.uses_table_round(jcfg)
    cfg = tengine.EngineConfig(mode=mc, merge_policy="trimmed", merge_trim=1)
    layout = convert.FlatLayout(_Quad(_data()[2]))
    with pytest.raises(ValueError, match="make_payload_round_steps"):
        tengine.make_round_step(_tquad, cfg, layout)


def test_adversarial_kinds_need_the_sketch_table_round():
    unc = dict(mode="uncompressed", momentum=0.9, momentum_type="virtual", error_type="none")
    with pytest.raises(ValueError, match="mode='sketch'"):
        _tsession("client_signflip@1:clients=0", mode=unc)
    with pytest.raises(ValueError, match="client_update_clip"):
        _tsession("client_normride@1:clients=0")
    s = _tsession("client_signflip@1:clients=0")
    assert s._table_round and s._payload_client is not None
    assert not s.supports_block_dispatch


# ------------------------------------------------- plans and parsing

PLANS = [
    "client_signflip@1,2:clients=0+2;client_scale@2:clients=1,factor=50",
    "seed=7;client_collude@1,3:frac=0.25",
    "seed=7;client_signflip@3:clients=0+1;client_collude@3:frac=0.25",
    "seed=11;client_collude@0,1,2,3:frac=0.5;client_scale@1:clients=3,factor=-4",
    "client_normride@1,2:clients=0+3,ride=0.9;client_normride@2:clients=1",
]


@pytest.mark.parametrize("text", PLANS)
def test_adversarial_plans_match_reference(text):
    tp, jp = TFaultPlan.parse(text), JFaultPlan.parse(text)
    assert [(s.kind, s.rounds, s.params) for s in tp.specs] == \
        [(s.kind, s.rounds, s.params) for s in jp.specs]
    assert tp.has_adversarial() == jp.has_adversarial()
    assert tp.has_normride() == jp.has_normride()
    for W in (8, 5):
        for rnd in range(5):
            for _ in range(2):  # the second call finds every site fired
                (ts, tsrc), (js, jsrc) = tp.adversarial_plan(rnd, W), jp.adversarial_plan(rnd, W)
                np.testing.assert_array_equal(ts, js)
                np.testing.assert_array_equal(tsrc, jsrc)
                assert (ts.dtype, tsrc.dtype) == (js.dtype, jsrc.dtype)
                np.testing.assert_array_equal(tp.normride_plan(rnd, W), jp.normride_plan(rnd, W))
        tp, jp = TFaultPlan.parse(text), JFaultPlan.parse(text)


def test_collude_single_worker_is_a_loud_noop():
    scale, src = TFaultPlan.parse("client_collude@1:frac=0.5").adversarial_plan(1, 1)
    np.testing.assert_array_equal(scale, np.ones(1, np.float32))
    np.testing.assert_array_equal(src, np.arange(1))


@pytest.mark.parametrize("text,match", [
    ("client_scale@1:clients=0,factor=0", "finite nonzero"),
    ("client_scale@1:clients=0,factor=nan", "finite nonzero"),
    ("client_collude@1:frac=0.9", "majority"),
    ("client_collude@1:frac=0", "majority"),
    ("client_normride@1:clients=0,ride=1.5", "ride fraction"),
    ("client_signflip@1:factor=2", "unknown param"),
])
def test_adversarial_parse_validation(text, match):
    for parse in (TFaultPlan.parse, JFaultPlan.parse):
        with pytest.raises(ValueError, match=match):
            parse(text)


def test_adversarial_schedule_validated_at_launch():
    plan = TFaultPlan.parse("client_signflip@9:clients=0")
    with pytest.raises(ValueError, match="can never fire"):
        plan.validate_rounds(5)
    plan.validate_rounds(10)


# --------------------------------------- table rounds against the reference

ATTACKS = {
    "signflip": "client_signflip@1,2:clients=0",
    "scale": "client_scale@1:clients=1,factor=50",
    "collude": "seed=3;client_collude@1,2:frac=0.25",
    "normride": "client_normride@1,2:clients=0,ride=0.9",
}
POLICIES = {"sum": {}, "trimmed": {"merge_policy": "trimmed", "merge_trim": 1},
            "median": {"merge_policy": "median"}}


@pytest.mark.parametrize("attack", list(ATTACKS))
@pytest.mark.parametrize("policy", list(POLICIES))
def test_table_round_under_attack_matches_reference(policy, attack):
    """The table round forced by the attack (and by the robust policy),
    against the reference's single-device table round: counts exact,
    params within ATOL."""
    kw = dict(POLICIES[policy])
    if attack == "normride":
        kw["client_update_clip"] = 3.0
    j, t = _jsession(ATTACKS[attack], **kw), _tsession(ATTACKS[attack], **kw)
    assert j._table_round and t._table_round
    mj, mt = _run(j, 3), _run(t, 3)
    for a, b in zip(mj, mt):
        for k in ("participants", "clients_quarantined", "clients_dropped"):
            assert a.get(k) == b.get(k), (k, a, b)
        if "quarantine_median" in a:
            assert b["quarantine_median"] == pytest.approx(a["quarantine_median"], rel=1e-5)
        assert b["loss_sum"] == pytest.approx(a["loss_sum"], rel=1e-5)
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("policy", ["trimmed", "median"])
def test_robust_residual_round_matches_reference(policy):
    kw = dict(POLICIES[policy], robust_residual=True)
    j, t = _jsession("client_scale@1:clients=1,factor=50", **kw), \
        _tsession("client_scale@1:clients=1,factor=50", **kw)
    _run(j, 3), _run(t, 3)
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.state["mode_state"]["Verror"].numpy(),
                               np.asarray(j.state["mode_state"]["Verror"]), rtol=0, atol=ATOL)
    # the residual really entered Verror
    plain = _tsession("client_scale@1:clients=1,factor=50", **POLICIES[policy])
    _run(plain, 3)
    assert not np.array_equal(_tparams(plain), _tparams(t))
    assert np.isfinite(_tparams(t)).all()


def test_robust_round_masks_nonfinite_client_without_quarantine():
    for make in (_jsession, _tsession):
        s = make("client_poison@1:clients=2,value=nan", merge_policy="median")
        ms = _run(s, 3)
        assert ms[1]["participants"] == 3.0, ms[1]
        assert all(np.isfinite(m["loss_sum"]) for m in ms)
    assert np.isfinite(_tparams(s)).all()


# ------------------------------------------------- within the port, bitwise

def test_trimmed_zero_is_sum_bitwise():
    for kw in ({}, {"wire_payloads": True}):
        a, b = _tsession(**kw), _tsession(merge_policy="trimmed", merge_trim=0, **kw)
        assert _run(a) == _run(b)
        assert np.array_equal(_tparams(a), _tparams(b))
        assert b._table_round == bool(kw)


def test_robust_session_runs_blocks_round_by_round():
    a, b = _tsession(merge_policy="median"), _tsession(merge_policy="median")
    assert not a.supports_block_dispatch
    assert a.run_rounds([LR] * 3) == [b.run_round(LR) for _ in range(3)]
    assert np.array_equal(_tparams(a), _tparams(b))


def test_scale_attack_quarantined_params_equal_drop():
    """A scaled table the merge quarantines is, in params, the round
    without that client (through the attacked round: a dropped client is
    also queued for later, which a quarantined one is not)."""
    a = _tsession("client_scale@2:clients=1,factor=100", client_update_clip=3.0,
                  wire_payloads=True)
    ms = _run(a, 3)
    assert [m["clients_quarantined"] for m in ms] == [0.0, 0.0, 1.0]
    b = _tsession("client_drop@2:clients=1", client_update_clip=3.0, wire_payloads=True)
    _run(b, 3)
    assert np.array_equal(_tparams(a), _tparams(b))
    assert all(torch.equal(a.state["quarantine"][k], b.state["quarantine"][k])
               for k in a.state["quarantine"])


def test_wire_rejection_equals_merge_quarantine_bitwise():
    """The same attacked payload, once rejected at the wire (QUARANTINED:
    arrived 0, a zero row) and once admitted and quarantined by the merge's
    table screen: the same committed state, bitwise."""

    def served_round(reject_at_wire):
        s = _tsession(client_update_clip=3.0, quarantine_window=2, wire_payloads=True)
        _run(s, 1)  # seeds the table-space ring
        rnd = s.round
        ids = s.sample_cohort(rnd)
        prep = s.prepare_served_round(rnd, ids, np.ones(len(ids), np.float32))
        tables, aux = s.compute_client_tables(prep)
        attacked = np.array(tables, copy=True)
        attacked[1] *= 100.0
        qmed = s.quarantine_median_host()
        assert qmed == float(s.state["quarantine"]["median"]) > 0.0
        policy = PayloadPolicy(rows=3, cols=8, clip_multiple=3.0,
                               quarantine_median=s.quarantine_median_host)
        arrived = np.ones(len(ids), np.float32)
        wire = np.array(attacked, copy=True)
        if reject_at_wire:
            assert validate_payload(attacked[1], policy)[1] == QUARANTINED
            arrived[1] = 0.0
            wire[1] = 0.0
        else:
            assert validate_payload(attacked[1], PayloadPolicy(rows=3, cols=8))[1] == ACCEPTED
        prep = s.finish_served_payload(prep, arrived, wire, aux)
        return s, s.commit_round(s.dispatch_round(prep, LR))[0]

    a, ma = served_round(True)
    b, mb = served_round(False)
    assert (ma["clients_quarantined"], mb["clients_quarantined"]) == (0.0, 1.0)
    assert ma["participants"] == mb["participants"]
    assert np.array_equal(_tparams(a), _tparams(b))
    for part in ("mode_state", "quarantine"):
        assert all(torch.equal(a.state[part][k], b.state[part][k]) for k in a.state[part])


# --------------------------------------------- attack A/B (the port's runs)

_AB_ROUNDS = 6
_AB_ALL = ",".join(str(r) for r in range(_AB_ROUNDS))
AB_ATTACKS = {
    "client_signflip": f"client_signflip@{_AB_ALL}:clients=0+1",
    "client_scale": f"client_scale@{_AB_ALL}:clients=0+1,factor=25",
    "client_collude": f"client_collude@{_AB_ALL}:frac=0.15",
}
_AB_RS = np.random.RandomState(0)
_AB_X = _AB_RS.randn(240, DIN).astype(np.float32)
_AB_Y = (_AB_X @ _AB_RS.randn(DIN, DOUT).astype(np.float32)).argmax(-1).astype(np.int32)
_AB_POLICIES = {"sum": {"merge_policy": "trimmed", "merge_trim": 0, "wire_payloads": True},
                "trimmed": {"merge_policy": "trimmed", "merge_trim": 3},
                "median": {"merge_policy": "median"}}


def _ab_arm(policy_kw, plan=None) -> float:
    """tests/test_byzantine.py's A/B harness in the port: 12 clients of
    concentrated gradients, no momentum, and the exact eval loss."""
    train = TFedDataset(_AB_X, _AB_Y, tshard_iid(len(_AB_X), 12, np.random.RandomState(1)))
    model = _Quad(np.full((DIN, DOUT), 0.1, np.float32))
    layout = convert.FlatLayout(model)
    s = TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                 params=dict(model.named_parameters()), net_state={}, layout=layout,
                 mode_cfg=TModeConfig(mode="sketch", d=layout.d, k=8, num_rows=3,
                                      num_cols=16, momentum=0.0, momentum_type="none",
                                      error_type="virtual"),
                 train_set=train, num_workers=12, local_batch_size=16, seed=0,
                 fault_plan=TFaultPlan.parse(plan), device="cpu", **policy_kw)
    for _ in range(_AB_ROUNDS):
        s.run_round(LR)
    ev = s.evaluate(train, batch_size=64)
    return ev["loss_sum"] / max(ev["count"], 1)


@pytest.mark.parametrize("kind", list(AB_ATTACKS))
def test_attack_degrades_sum_robust_recovers(kind):
    """The attacked sum ends measurably worse than its clean run; trimmed
    and median stay within 0.75 x the sum's damage of their own clean runs
    and beat the attacked sum (the reference's acceptance A/B)."""
    clean = {p: _ab_arm(kw) for p, kw in _AB_POLICIES.items()}
    att = {p: _ab_arm({k: v for k, v in kw.items() if k != "wire_payloads"}, AB_ATTACKS[kind])
           for p, kw in _AB_POLICIES.items()}
    deg = att["sum"] - clean["sum"]
    assert deg > 0.05, (kind, clean, att)
    for policy in ("trimmed", "median"):
        assert att[policy] - clean[policy] < 0.75 * deg, (kind, policy, clean, att)
        assert att[policy] < att["sum"], (kind, policy, att)


def test_attacks_count_and_trace():
    reg = obreg.default()
    mark = reg.mark()
    s = _tsession("client_signflip@1:clients=0;client_scale@2:clients=1,factor=5;"
                  "client_normride@1:clients=2", client_update_clip=3.0)
    _run(s, 3)
    for kind in ("signflip", "scale", "normride"):
        assert mark.delta(f"resilience_attack_{kind}_total") == 1.0, kind
    assert mark.delta("resilience_faults_injected_total") >= 3.0
