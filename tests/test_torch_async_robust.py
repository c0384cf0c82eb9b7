"""The buffered-async service's merge arithmetic and its robust composition
(``engine._stale_fold``, ``modes._weighted_table_merge``), the stale band's
checkpoints and ``client_stale_poison``, on the CPU.

Against the JAX package (the reference's ravel, single-device path; the
inputs from a numpy seed, the quad model of tests/test_async_robust.py built
in both packages with the same parameters and data):

- ``_stale_fold`` within rtol 1e-6, atol 1e-6 of the reference's: XLA:CPU
  contracts the reference's ``tbl + w * t`` into a fused multiply-add, and
  the port's two eager operations round twice (one float32 ulp a slot at
  most); the port's fold is bitwise the same two-operation left fold in
  numpy, and the live weight plus the stale weights and the metrics match
  exactly;
- the weighted union-stack robust merge (median and trimmed, with stale
  slots, NaN rows and empty slots, with and without the residual): equal
  to the reference's bitwise at these sizes (no lo/hi flip of the weighted
  median); the residual and the total weight within rtol 1e-6; both within
  rtol 1e-5 of the reference's float64 numpy definition. At a union stack
  of 200 rows the weighted median's lo/hi index can flip where the float32
  cumulative weight sits within rounding of half the total (ROADMAP Queue
  3, expected divergences): the test pins that every flip is such a tie;
- served async rounds with stragglers folded into the trimmed merge, and
  a ``client_stale_poison`` run: the per-round ``stale_folded`` equal,
  ``stale_weight`` within rel 1e-6, the casualties equal and the params
  within atol 1e-5 (tests/test_torch_serve.py's tolerance: the packages
  add clients in another float order);
- the stale band's checkpoint codec, field for field both ways.

Within the port, bitwise: the weighted form at unit weights and no slots
equals the unweighted form (with empty slots too, value for value); an
async robust run with everyone on time equals the sync robust run, and
trimmed@0 the sync sum; the union stack at ``client_shards`` 2 equals the
unsharded run; a session and service reused after a stopped loop replay
the uninterrupted run with the band rewound; the CLI preempted with a
non-empty band and resumed equals the uninterrupted CLI run."""

import collections
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import test_async_robust as jar
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.modes import modes as jmodes
from commefficient_tpu.resilience import FaultPlan as JFaultPlan
from commefficient_tpu.serve import service as jservice
from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.federated.api import FedOptimizer
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.runner.loop import RunnerConfig, run_loop
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.sketch import csvec
from test_torch_runner import _assert_state_equal, tiny_cv  # noqa: F401
from test_torch_serve import _tquad

torch.set_num_threads(2)

LR = jar.LR
ATOL = 1e-5
SPEC = csvec.CSVecSpec(d=100, c=64, r=3, seed=1, family="rotation")


class _Quad(torch.nn.Module):
    """tests/test_async_robust.py's model: w = 0.1 everywhere, b = 0."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((6, 3), 0.1))
        self.b = torch.nn.Parameter(torch.zeros(3))


@pytest.fixture()
def quad(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", {"w": ("w",), "b": ("b",)}.__getitem__)


def _tsession(num_workers=12, stale_slots=0, fault_plan=None, **kw):
    """The port's twin of the reference's ``make_session``."""
    train = TFedDataset(jar._X, jar._Y, tshard_iid(len(jar._X), 12, np.random.RandomState(1)))
    model = _Quad()
    layout = convert.FlatLayout(model)
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(model.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(mode="sketch", d=layout.d, k=8, num_rows=3,
                                         num_cols=16, momentum=0.0, momentum_type="none",
                                         error_type="virtual"),
                    train_set=train, num_workers=num_workers, local_batch_size=16, seed=0,
                    device="cpu", wire_payloads=True, stale_slots=stale_slots,
                    fault_plan=TFaultPlan.parse(fault_plan), **kw)


def _tserve(session, cfg, rounds):
    """The port's twin of the reference's ``serve_rounds``: served rounds in
    the run loop's dispatch shape, then the loop's exit rewind; the rows."""
    svc = tservice.AggregationService(session, cfg, traffic=ttraffic.TrafficGenerator(
        ttraffic.TraceConfig(population=session.train_set.num_clients, seed=5))).start()
    rows = []
    try:
        src = svc.source()
        for _ in range(rounds):
            prep = src.next()
            rows.append(session.commit_round(session.dispatch_round(prep, LR))[0])
            src.on_dispatched(session.round - 1)
            src.on_committed(session.round)
        src.stop()
        with session.mutate_lock:
            session.rng.set_state(session.rng_snapshot)
            session._requeue = collections.deque(session._requeue_committed)
            session._requeue_enqueued = dict(session._requeue_ages_committed)
    finally:
        svc.close()
    return rows


def _jparams(s):
    return np.asarray(ravel_pytree(jax.device_get(s.state["params"]))[0])


# ------------------------------------------------------------------ the fold


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stale_fold_matches_reference(seed):
    rs = np.random.RandomState(seed)
    table = rs.randn(3, 257).astype(np.float32)
    stale = rs.randn(4, 3, 257).astype(np.float32)
    w = np.array([2 ** -0.5, 3 ** -0.5, 0.0, 0.75], np.float32)  # slot 2 empty
    live = np.float32(5.0)
    jt, jw, jm = jengine._stale_fold(jnp.asarray(table), jnp.asarray(live), jnp.asarray(stale),
                                     jnp.asarray(w))
    tt, tw, tm = tengine._stale_fold(torch.from_numpy(table), torch.tensor(live),
                                     torch.from_numpy(stale), torch.from_numpy(w))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)
    assert float(tw) == float(jw) == float(np.float32(live + w[0] + w[1] + w[2] + w[3]))
    assert int(tm["stale_folded"]) == int(jm["stale_folded"]) == 3
    assert float(tm["stale_weight"]) == pytest.approx(float(jm["stale_weight"]), rel=1e-6)
    # the port's association: the left fold of two float32 operations a slot
    want = table.copy()
    for i in range(len(w)):
        want = (want + (w[i] * stale[i]).astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(tt.numpy(), want)


def test_merge_with_no_stale_slot_never_calls_the_fold(quad, monkeypatch):
    """The plain merge's code path: an async round with no late table
    dispatches the merge with no fold (and the fold's one site sees only
    rounds that have one)."""
    calls = []
    fold = tengine._stale_fold
    monkeypatch.setattr(tengine, "_stale_fold", lambda *a: calls.append(1) or fold(*a))
    s = _tsession(stale_slots=12)
    _tserve(s, tservice.ServeConfig(quorum=12, deadline_s=1e9, payload="sketch",
                                    async_mode=True, buffer_size=12), 3)
    assert calls == []
    s = _tsession(stale_slots=12)
    rows = _tserve(s, tservice.ServeConfig(quorum=12, deadline_s=60.0, payload="sketch",
                                           async_mode=True, buffer_size=6), 3)
    assert len(calls) == sum(1 for r in rows if "stale_folded" in r) > 0


# ---------------------------------------------- the weighted union-stack merge


def _case(name):
    rs = np.random.RandomState(11)
    tables = rs.randn(6, 3, 64).astype(np.float32)
    live = np.array([1, 0, 1, 1, 1, 1], np.float32)
    stale = rs.randn(3, 3, 64).astype(np.float32)
    sw = np.array([2 ** -0.5, 3 ** -0.5, 0.0], np.float32)
    if name == "nan_rows":
        tables[3, 1, 7] = np.nan
        stale[1, 0, 0] = np.inf
    elif name == "empty_slots":
        stale[:] = 0.0
        sw[:] = 0.0
    return tables, live, stale, sw


CASES = ["stale", "nan_rows", "empty_slots"]
POLICIES = [("median", 0), ("trimmed", 1), ("trimmed", 2)]


def _both(tables, live, stale, sw, policy, trim, residual=True):
    j = jmodes._robust_table_merge(jnp.asarray(tables), jnp.asarray(live), policy, trim,
                                   stale_tables=jnp.asarray(stale),
                                   stale_weights=jnp.asarray(sw), want_residual=residual)
    t = tmodes._robust_table_merge(SPEC, torch.from_numpy(tables), torch.from_numpy(live),
                                   policy, trim, want_residual=residual,
                                   stale_tables=torch.from_numpy(stale),
                                   stale_weights=torch.from_numpy(sw))
    return j, t


@pytest.mark.parametrize("policy,trim", POLICIES)
@pytest.mark.parametrize("case", CASES)
def test_weighted_union_merge_matches_reference(case, policy, trim):
    tables, live, stale, sw = _case(case)
    j, t = _both(tables, live, stale, sw, policy, trim)
    # bitwise at this size: the same ranks, the same weighted median rows
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    assert float(t[1]) == pytest.approx(float(j[1]), rel=1e-6)
    np.testing.assert_allclose(t[2]["residual"].numpy(), np.asarray(j[2]["residual"]),
                               rtol=1e-6, atol=1e-7)
    assert int(t[2]["stale_folded"]) == int(j[2]["stale_folded"])
    assert float(t[2]["stale_weight"]) == pytest.approx(float(j[2]["stale_weight"]), rel=1e-6)
    # without the residual the same estimate and extras, and no residual
    robust, total, extras = tmodes._robust_table_merge(
        SPEC, torch.from_numpy(tables), torch.from_numpy(live), policy, trim,
        stale_tables=torch.from_numpy(stale), stale_weights=torch.from_numpy(sw))
    assert torch.equal(robust, t[0]) and "residual" not in extras and float(total) == float(t[1])


@pytest.mark.parametrize("case", CASES)
def test_weighted_union_merge_matches_numpy_definition(case):
    """tests/test_async_robust.py's float64 per-coordinate definitions."""
    tables, live, stale, sw = _case(case)
    union, uw = np.concatenate([tables, stale]), np.concatenate([live, sw])
    for policy, trim in POLICIES:
        _, t = _both(tables, live, stale, sw, policy, trim, residual=False)
        if policy == "trimmed":
            want, total = jar._np_weighted_trimmed(union, uw, trim)
            assert float(t[1]) == pytest.approx(total, rel=1e-6)
        else:
            want = jar._np_weighted_median(union, uw)
        np.testing.assert_allclose(t[0].numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("policy,trim", POLICIES)
def test_unit_weights_reduce_to_the_unweighted_form_bitwise(policy, trim, residual):
    rs = np.random.RandomState(7)
    tables = torch.from_numpy(rs.randn(6, 3, 64).astype(np.float32))
    tables[4, 2, 9] = float("nan")
    live = torch.tensor([1, 0, 1, 1, 1, 1], dtype=torch.float32)
    old = tmodes._robust_table_merge(SPEC, tables, live, policy, trim, want_residual=residual)
    # no slots, then three empty ones: the weighted form's own branch
    for k in (0, 3):
        new = tmodes._robust_table_merge(SPEC, tables, live, policy, trim,
                                         want_residual=residual,
                                         stale_tables=torch.zeros(k, 3, 64),
                                         stale_weights=torch.zeros(k))
        if residual:
            assert torch.equal(new[0], old[0]) and torch.equal(new[2]["residual"],
                                                               old[2]["residual"])
            assert torch.equal(new[1], old[1])
        else:
            assert torch.equal(new[0], old)
            assert float(new[1]) == float(live.sum()) - 1.0  # the NaN row left
        assert int(new[2]["stale_folded"]) == 0 and float(new[2]["stale_weight"]) == 0.0


def test_weighted_median_flips_only_at_a_rounding_tie():
    """At a 200-row union stack the port's left-fold cumulative weight and
    the reference's ``jnp.cumsum`` (and their totals) round differently; a
    coordinate's lo/hi index may then differ, but only where the float64
    cumulative weight lies within float32 rounding of half the total."""
    W = K = 100
    rs = np.random.RandomState(1)
    tables = rs.randn(W, 3, 256).astype(np.float32)
    live = (rs.rand(W) > 0.2).astype(np.float32)
    stale = rs.randn(K, 3, 256).astype(np.float32)
    sw = ((1.0 + rs.randint(1, 4, K)) ** -0.5).astype(np.float32)
    sw[rs.rand(K) < 0.3] = 0
    spec = csvec.CSVecSpec(d=100, c=256, r=3, seed=1, family="rotation")
    j = np.asarray(jmodes._robust_table_merge(
        jnp.asarray(tables), jnp.asarray(live), "median", 0, stale_tables=jnp.asarray(stale),
        stale_weights=jnp.asarray(sw), want_residual=True)[0])
    t = tmodes._robust_table_merge(spec, torch.from_numpy(tables), torch.from_numpy(live),
                                   "median", 0, stale_tables=torch.from_numpy(stale),
                                   stale_weights=torch.from_numpy(sw))[0].numpy()
    union = np.concatenate([tables, stale]).reshape(W + K, -1)
    w = np.concatenate([live, sw]).astype(np.float64)
    half = w.sum() / 2
    diff = np.flatnonzero(j.reshape(-1) != t.reshape(-1))
    assert len(diff) < 0.05 * j.size, len(diff)
    for c in diff:
        order = np.argsort(np.where(w > 0, union[:, c], np.inf), kind="stable")
        cum = np.cumsum(w[order])
        assert np.abs(cum - half).min() <= 1e-5 * w.sum(), c


# ------------------------------------------------------- served async rounds


def _cfg(**kw):
    return tservice.ServeConfig(payload="sketch", **kw)


@pytest.mark.parametrize("policy,kw", [("median", {}), ("trimmed", {"merge_trim": 3})])
def test_async_robust_zero_stale_bitwise_equals_sync_robust(quad, policy, kw):
    a = _tsession(merge_policy=policy, **kw)
    ra = _tserve(a, _cfg(quorum=12, deadline_s=1e9), 4)
    b = _tsession(merge_policy=policy, stale_slots=12, **kw)
    rb = _tserve(b, _cfg(quorum=12, deadline_s=1e9, async_mode=True, buffer_size=12), 4)
    assert ra == rb
    _assert_state_equal(a, b)


def test_trimmed_zero_async_on_time_bitwise_equals_sync_sum(quad):
    a = _tsession()
    ra = _tserve(a, _cfg(quorum=12, deadline_s=1e9), 4)
    b = _tsession(merge_policy="trimmed", merge_trim=0, stale_slots=12)
    rb = _tserve(b, _cfg(quorum=12, deadline_s=1e9, async_mode=True, buffer_size=12), 4)
    assert ra == rb
    _assert_state_equal(a, b)


def _assert_rows_match(trows, jrows):
    """Per round: the same casualties and folds; the stale weight within
    rel 1e-6 (the packages sum the slot weights in another order)."""
    for tr, jr in zip(trows, jrows, strict=True):
        assert set(tr) == {k for k in jr if not k.startswith(("health/", "ledger/"))}, (tr, jr)
        for k in ("participants", "clients_dropped", "stale_folded"):
            if k in jr:
                assert tr[k] == float(jr[k]), (k, tr, jr)
        if "stale_weight" in jr:
            assert tr["stale_weight"] == pytest.approx(float(jr["stale_weight"]), rel=1e-6)


def test_async_robust_stragglers_fold_into_the_union_stack_as_the_reference(quad):
    """Buffer 6 of 12: the stragglers join the trimmed merge's weighted
    order statistics, as in the reference, and the run differs from the sync
    robust run that drops them."""
    reg = obreg.default()
    base = reg.counter("serve_stale_folded_total").value
    j = jar.make_session(merge_policy="trimmed", merge_trim=3, stale_slots=12)
    jrows = jar.serve_rounds(j, jservice.ServeConfig(quorum=12, deadline_s=60.0,
                                                     payload="sketch", async_mode=True,
                                                     buffer_size=6), 5)
    t = _tsession(merge_policy="trimmed", merge_trim=3, stale_slots=12)
    trows = _tserve(t, _cfg(quorum=12, deadline_s=60.0, async_mode=True, buffer_size=6), 5)
    _assert_rows_match(trows, jrows)
    folded = [r for r in trows if r.get("stale_folded", 0) > 0]
    assert folded and all(0 < r["stale_weight"] < r["stale_folded"] for r in folded), trows
    assert reg.counter("serve_stale_folded_total").value > base
    np.testing.assert_allclose(t.state["params"].numpy(), _jparams(j), atol=ATOL)
    assert list(t._requeue) == [int(c) for c in j._requeue]
    b = _tsession(merge_policy="trimmed", merge_trim=3)
    _tserve(b, _cfg(quorum=6, deadline_s=60.0), 5)
    assert not torch.equal(t.state["params"], b.state["params"])


def test_async_robust_union_stack_shard_invariant(quad):
    def run(shards):
        s = _tsession(merge_policy="trimmed", merge_trim=3, stale_slots=12,
                      client_shards=shards)
        rows = _tserve(s, _cfg(quorum=12, deadline_s=60.0, async_mode=True, buffer_size=6), 4)
        return s, rows

    (a, ra), (b, rb) = run(0), run(2)
    assert ra == rb and any(r.get("stale_folded", 0) for r in ra)
    _assert_state_equal(a, b)


# -------------------------------------------------------- client_stale_poison


def test_stale_poison_is_wire_faithful_and_matches_reference(quad):
    """The withheld position is a no-show of round 1 (masked and queued),
    its poisoned table is ACCEPTED_STALE through the real band at round 2's
    serving and folds into round 2's merge; the attack counter fires once;
    the run matches the reference's."""
    reg = obreg.default()
    mark = reg.mark()
    plan = "client_stale_poison@1:clients=0"
    cfg = dict(quorum=12, deadline_s=1e9, payload="sketch", async_mode=True, buffer_size=10)
    j = jar.make_session(stale_slots=12, client_update_clip=10.0,
                         fault_plan=JFaultPlan.parse(plan))
    jrows = jar.serve_rounds(j, jservice.ServeConfig(**cfg), 4)
    mark = reg.mark()
    t = _tsession(stale_slots=12, client_update_clip=10.0, fault_plan=plan)
    trows = _tserve(t, tservice.ServeConfig(**cfg), 4)
    assert mark.delta("resilience_attack_stale_poison_total") == 1.0
    assert mark.delta("serve_stale_admitted_total") >= 1.0
    assert trows[1]["clients_dropped"] >= 1 and trows[2]["stale_folded"] >= 1, trows
    _assert_rows_match(trows, jrows)
    np.testing.assert_allclose(t.state["params"].numpy(), _jparams(j), atol=ATOL)


def test_stale_poison_validation():
    plan = TFaultPlan.parse("client_stale_poison@1:clients=0")
    assert plan.has_stale_poison()
    with pytest.raises(ValueError, match="stale band"):
        plan.validate_stale_context(False)
    plan.validate_stale_context(True)
    with pytest.raises(ValueError, match="finite nonzero"):
        TFaultPlan.parse("client_stale_poison@1:clients=0,factor=0")
    plan.validate_rounds(3)
    with pytest.raises(ValueError, match="NEXT round"):
        plan.validate_rounds(2)


# ----------------------------------------------------- the band's checkpoints


def _band_run(session=None):
    s = session or _tsession(stale_slots=12, client_update_clip=10.0,
                             fault_plan="client_stale_poison@2:clients=0")
    svc = tservice.AggregationService(
        s, _cfg(quorum=12, deadline_s=1e9, async_mode=True, buffer_size=10),
        traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12, seed=5))).start()
    return s, svc


def test_band_state_rides_serve_meta_and_restores(quad):
    s, svc = _band_run()
    try:
        src = svc.source()
        for _ in range(3):
            prep = src.next()
            s.commit_round(s.dispatch_round(prep, LR))
            src.on_dispatched(s.round - 1)
            src.on_committed(s.round)
        meta = s.serve_meta()
        src.stop()
    finally:
        svc.close()
    band = meta["band"]
    assert meta["round"] == 3
    assert len(band["stale"]) + len(band["stash"]) + len(band["poison"]) >= 1, band
    s2 = _tsession(stale_slots=12, client_update_clip=10.0)
    s2.restored_serve_meta = json.loads(json.dumps(meta))
    _, svc2 = _band_run(session=s2)
    try:
        qb = svc2.queue.band_snapshot()
        assert len(qb["stale"]) == len(band["stale"])
        assert len(svc2._stale_stash) == len(band["stash"])
        assert len(svc2._stale_poison_pending) == len(band["poison"])
        assert tservice._enc_band(qb, svc2._stale_stash, svc2._stale_poison_pending) == band
    finally:
        svc2.close()


def test_band_codec_reads_across_packages():
    """A band written by either package decodes in the other to the same
    band, and both encode it to the same JSON."""
    rs = np.random.RandomState(2)
    t = [rs.randn(3, 16).astype(np.float32) for _ in range(4)]
    band = {"stale": [(4, 7, 0.25, 19, 0.0, t[0])],
            "recent": [(3, 1.5, {7: 0, 9: 1}, {9, 7}), (4, 2.5, {2: 0}, set())],
            "newest": 5, "recv_counter": 20}
    stash, poison = [(4, 1, 9, t[1]), (4, 12, 2, t[2])], [(5, 0, 3, t[3])]
    jenc, tenc = jservice._enc_band(band, stash, poison), tservice._enc_band(band, stash, poison)
    assert json.dumps(jenc) == json.dumps(tenc)
    for enc in (json.loads(json.dumps(jenc)), json.loads(json.dumps(tenc))):
        for dec in (jservice._dec_band, tservice._dec_band):
            qb, st, po = dec(enc)
            assert qb["newest"] == 5 and qb["recv_counter"] == 20
            assert [(r, m, inv, seen) for r, m, inv, seen in qb["recent"]] == \
                [(r, m, inv, seen) for r, m, inv, seen in band["recent"]]
            assert [e[:5] for e in qb["stale"]] == [(4, 7, 0.25, 19, 0.0)]
            np.testing.assert_array_equal(qb["stale"][0][5], t[0])
            for got, want in zip(st + po, stash + poison, strict=True):
                assert got[:3] == want[:3] and got[3].dtype == np.float32
                np.testing.assert_array_equal(got[3], want[3])


def test_rewind_restores_the_committed_band_on_session_reuse(quad):
    def build():
        s = _tsession(merge_policy="trimmed", merge_trim=3, stale_slots=12)
        svc = tservice.AggregationService(
            s, _cfg(quorum=12, deadline_s=60.0, async_mode=True, buffer_size=6),
            traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12,
                                                                   seed=5))).start()
        return s, svc

    a, svc_a = build()
    try:
        opt = FedOptimizer(lambda e: LR, 3)
        for n in (2, 5):
            run_loop(a, opt, RunnerConfig(total_rounds=n, eval_every=100),
                     source=svc_a.source())
    finally:
        svc_a.close()
    b, svc_b = build()
    try:
        run_loop(b, FedOptimizer(lambda e: LR, 3), RunnerConfig(total_rounds=5,
                                                                eval_every=100),
                 source=svc_b.source())
    finally:
        svc_b.close()
    assert a.round == b.round == 5
    _assert_state_equal(a, b)
    assert list(a._requeue) == list(b._requeue)


ASYNC_CLI = ["--dataset", "cifar10", "--mode", "sketch", "--k", "64", "--num_rows", "3",
             "--num_cols", "256", "--num_clients", "8", "--num_workers", "4",
             "--local_batch_size", "4", "--lr_scale", "0.05", "--weight_decay", "0",
             "--data_root", "/nonexistent", "--device", "cpu", "--num_rounds", "6",
             "--eval_every", "3", "--serve", "inproc", "--serve_payload", "sketch",
             "--serve_async", "--serve_buffer", "3", "--serve_deadline", "30.0",
             "--merge_policy", "trimmed", "--merge_trim", "1"]


def test_cli_async_preempt_resume_nonempty_band_bitwise(tiny_cv, tmp_path):  # noqa: F811
    """tests/test_async_robust.py:639 on the port's CLI: the stale band is
    non-empty when the preemption hits round 3; the band rides meta.json
    and the resume ends bitwise on the uninterrupted run, queue included."""
    plan = "wire_delay@2,3:clients=1,secs=5"
    ck = str(tmp_path / "ck")
    chaos = ["--checkpoint_dir", ck, "--checkpoint_every", "1", "--sync_loop"]
    with pytest.raises(SystemExit) as ei:
        cv_train.main(ASYNC_CLI + ["--fault_plan", plan + ";preempt@3"] + chaos)
    assert ei.value.code == EXIT_RESUMABLE
    with open(sorted(glob.glob(os.path.join(ck, "round_*", "meta.json")))[-1]) as f:
        band = json.load(f)["serve"]["band"]
    assert len(band["stale"]) + len(band["stash"]) >= 1, band
    resumed = cv_train.main(ASYNC_CLI + ["--fault_plan", plan + ";preempt@3"] + chaos
                            + ["--resume"])
    assert resumed.round == 6
    whole = cv_train.main(ASYNC_CLI + ["--fault_plan", plan, "--sync_loop"])
    _assert_state_equal(whole, resumed)
    assert list(whole._requeue) == list(resumed._requeue)
    assert whole._requeue_enqueued == resumed._requeue_enqueued


# ---------------------------------------------------------------- validation


def test_engine_config_composes_async_with_robust_and_needs_the_wire():
    mc = TModeConfig(mode="sketch", d=16, k=4, num_rows=2, num_cols=8,
                     momentum_type="virtual", error_type="virtual")
    cfg = tengine.EngineConfig(mode=mc, stale_slots=4, wire_payloads=True,
                               merge_policy="trimmed", merge_trim=1)
    assert tengine.robust_policy(cfg) == "trimmed"
    with pytest.raises(ValueError, match="wire"):
        tengine.EngineConfig(mode=mc, stale_slots=4)
    with pytest.raises(ValueError, match="stale_slots must be >= 0"):
        tengine.EngineConfig(mode=mc, stale_slots=-1, wire_payloads=True)


def test_finish_served_payload_needs_stale_slots(quad):
    s = _tsession()
    ids = s.sample_cohort(0)
    prep0 = s.prepare_served_round(0, ids, np.ones(len(ids), np.float32))
    tables, aux = s.compute_client_tables(prep0)
    with pytest.raises(ValueError, match="stale_slots=0"):
        s.finish_served_payload(prep0, np.ones(len(ids), np.float32), tables, aux,
                                stale=(np.zeros((1, 3, 16), np.float32),
                                       np.ones(1, np.float32)))
    t = _tsession(stale_slots=2)
    prep0 = t.prepare_served_round(0, ids, np.ones(len(ids), np.float32))
    with pytest.raises(ValueError, match="does not fit"):
        t.finish_served_payload(prep0, np.ones(len(ids), np.float32), tables, aux,
                                stale=(np.zeros((3, 3, 16), np.float32),
                                       np.ones(3, np.float32)))
