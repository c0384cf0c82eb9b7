"""The two-tier edge tree (``--serve_edges E``, the ``edge_kill`` fault kind;
``commefficient_tpu_torch/serve/scale/edge.py``, ``modes.edge_grouped_sum``
/ ``merge_edge_partials``, the edge merges of the payload round) on the
CPU.

Against the JAX package, on the same numpy-seeded inputs:

- ``assign_edges``, ``table_norms_host`` (a shard with no rows included),
  ``screen_mask`` (a norm exactly on clip x median), ``_shard_fold``
  (``-0.0`` entries, a NaN table in a dead row) and ``EdgeTree``'s round
  (partials, norms, assignment; a dead edge; forward mode): bitwise;
- ``edge_grouped_sum`` and ``merge_edge_partials`` against the reference's
  jitted ones, bitwise, and against per-edge folds plus the root fold,
  bitwise (tests/test_scale.py:167-206);
- the port's edge-tree served runs over the reference's four parameter
  sets (tests/test_scale.py:221-226): the same casualties, the params
  within atol 1e-5 (the one-device served runs' tolerance: the packages
  add clients in another float order).

Within the port, bitwise: the tree equals the flat twin (the same
edge-armed session served with ``edges=0``) over those four sets, a
client-sharded session and a short quorum included; the socket equals in
process; an edge's death equals the drop of its shard, requeue included;
forward mode under a robust policy equals the flat robust run, with the
NOTE on stderr; a CLI preempt -> 75 -> ``--resume`` through the tree
equals the uninterrupted run; four gloo ranks equal the one-device run at
``client_shards`` 4; a tiny GPT-2 served run with ``--serve_edges 2``
equals its flat twin. And every validation of the engine, the service
and both CLIs, in the reference's words.

The rank function lives here at module level (``launch_local`` pickles it
by name); this module imports no JAX at its top, so the ranks do not."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from commefficient_tpu_torch import cv_train, gpt2_train
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.resilience import faults as tfaults
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.serve.scale import edge as tedge
from commefficient_tpu_torch.serve.scale.shard import shard_for
from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults
from test_torch_group_serve import MESH, SKETCH as GROUP_SKETCH, _serve as _group_serve
from test_torch_group_serve import _snap, _twin
from test_torch_group_client_state import _session as _group_session
from test_torch_runner import _assert_state_equal, tiny_cv  # noqa: F401

torch.set_num_threads(2)

LR = 0.05
ATOL = 1e-5
# tests/test_scale.py's tiny payload session: 3 x 16 tables, 4 of 12 clients
SCALE_SKETCH = dict(mode="sketch", k=4, num_rows=3, num_cols=16, momentum_type="virtual",
                    error_type="virtual")


DIN, DOUT = 6, 3


def _data():
    """tests/test_scale.py's data and initial weights, drawn in its order."""
    rs = np.random.RandomState(0)
    x = rs.randn(96, DIN).astype(np.float32)
    w_true = rs.randn(DIN, DOUT).astype(np.float32)
    y = (x @ w_true).argmax(-1).astype(np.int32)
    return x, y, rs.randn(DIN, DOUT).astype(np.float32) * 0.1


def _tquad(params, net_state, batch, gen=None):
    pred = batch["x"] @ params["w"] + params["b"]
    err = pred - (batch["y"].long()[:, None] == torch.arange(pred.shape[-1])).float()
    mask = batch["mask"]
    per_ex = (err ** 2).sum(-1)
    return (per_ex * mask).sum() / mask.sum().clamp_min(1.0), {
        "net_state": net_state,
        "metrics": {"loss_sum": (per_ex * mask).sum(), "count": mask.sum()}}


class _Quad(torch.nn.Module):
    def __init__(self, w0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        self.b = torch.nn.Parameter(torch.zeros(DOUT))


def _jedge():
    from commefficient_tpu.serve.scale import edge

    return edge


def _jscale():
    import test_scale

    return test_scale


def _tsession(serve_edges=0, clip=0.0, shards=1, workers=4, merge_policy="sum", merge_trim=0,
              fault_plan=None):
    """The port's twin of tests/test_scale.py's ``_tiny_session``."""
    x, y, w0 = _data()
    train = TFedDataset(x, y, tshard_iid(len(x), 12, np.random.RandomState(1)))
    model = _Quad(w0)
    orig, convert.flax_path = convert.flax_path, {"w": ("w",), "b": ("b",)}.__getitem__
    try:
        layout = convert.FlatLayout(model)
    finally:
        convert.flax_path = orig
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(model.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(d=layout.d, **SCALE_SKETCH), train_set=train,
                    num_workers=workers, local_batch_size=4, seed=0, device="cpu",
                    wire_payloads=True, serve_edges=serve_edges, client_update_clip=clip,
                    client_shards=shards, merge_policy=merge_policy, merge_trim=merge_trim,
                    fault_plan=TFaultPlan.parse(fault_plan or ""))


def _tserve(session, rounds, edges=0, transport="inproc", quorum=3, trace_seed=5,
            deadline=4.0, **cfg):
    """tests/test_scale.py's ``_serve`` on the port: served rounds through
    the dispatch shape; (the metric rows, each round's masked positions,
    the closed service)."""
    svc = tservice.AggregationService(
        session, tservice.ServeConfig(quorum=quorum, deadline_s=deadline, transport=transport,
                                      payload="sketch", edges=edges, **cfg),
        traffic=ttraffic.TrafficGenerator(
            ttraffic.TraceConfig(population=session.train_set.num_clients,
                                 seed=trace_seed))).start()
    rows, drops = [], []
    try:
        src = svc.source()
        for _ in range(rounds):
            prep = src.next()
            drops.append(sorted(int(p) for p in np.flatnonzero(prep.payload[1] == 0.0)))
            rows.append(session.commit_round(session.dispatch_round(prep, LR))[0])
            src.on_dispatched(session.round - 1)
            src.on_committed(session.round)
        src.stop()
    finally:
        svc.close()
    return rows, drops, svc


def _jserve(session, rounds, edges, quorum, trace_seed):
    """The reference's run of tests/test_scale.py's ``_serve``, with each
    round's masked positions."""
    js = _jscale()
    drops = []
    dispatch = session.dispatch_round

    def recording(prep, lr):
        drops.append(sorted(int(p) for p in np.flatnonzero(np.asarray(prep.payload[1]) == 0.0)))
        return dispatch(prep, lr)

    session.dispatch_round = recording
    try:
        rows = js._serve(session, rounds, edges=edges, quorum=quorum, trace_seed=trace_seed)
    finally:
        session.dispatch_round = dispatch
    return rows, drops


def _jparams(s):
    import jax
    from jax.flatten_util import ravel_pytree

    return np.asarray(ravel_pytree(jax.device_get(s.state["params"]))[0])


def _full_state_equal(sa, sb):
    _assert_state_equal(sa, sb)
    for part in ("quarantine",):
        if part in sa.state:
            for k in sa.state[part]:
                assert torch.equal(sa.state[part][k], sb.state[part][k]), (part, k)


def _requeue(s):
    return list(s._requeue), dict(s._requeue_enqueued)


# ------------------------------------------------------ the host helpers


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_assign_edges_equals_reference_bitwise(n):
    ids = np.arange(20_000, dtype=np.int64) * 7919 + 11
    got = tedge.assign_edges(ids, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _jedge().assign_edges(ids, n))
    for cid in ids[:50]:
        assert got[list(ids).index(cid)] == shard_for(int(cid), n)
    assert set(np.unique(got)) == set(range(n))


def test_table_norms_host_equals_reference_and_partition_invariant():
    rs = np.random.RandomState(3)
    scale = np.logspace(-20, 18, 9).reshape(-1, 1, 1).astype(np.float32)
    tables = (rs.randn(9, 3, 5) * scale).astype(np.float32)
    tables[4, 0, 0] = np.inf
    full = tedge.table_norms_host(tables)
    assert full.dtype == np.float32
    np.testing.assert_array_equal(full, _jedge().table_norms_host(tables))
    assign = tedge.assign_edges(np.arange(100, 109), 3)
    for e in range(3):
        idx = np.flatnonzero(assign == e)
        np.testing.assert_array_equal(full[idx], tedge.table_norms_host(tables[idx]))
    empty = np.zeros((0, 3, 5), np.float32)
    assert tedge.table_norms_host(empty).shape == (0,)
    np.testing.assert_array_equal(tedge.table_norms_host(empty),
                                  _jedge().table_norms_host(empty))


def test_screen_mask_equals_reference_on_the_threshold():
    clip, median = 3.0, 1.7
    thresh = np.float32(clip) * np.float32(median)
    above = np.nextafter(thresh, np.float32(np.inf))
    below = np.nextafter(thresh, np.float32(0))
    norms = np.array([thresh, above, below, 0.0, np.nan, np.inf, 1e-30], np.float32)
    got = tedge.screen_mask(norms, clip, median)
    np.testing.assert_array_equal(got, [1, 0, 1, 1, 0, 0, 1])
    for c, m in ((clip, median), (0.0, median), (clip, 0.0)):
        np.testing.assert_array_equal(tedge.screen_mask(norms, c, m),
                                      _jedge().screen_mask(norms, c, m))
    # the merge step's mask over the same norms and median agrees
    cfg = tengine.EngineConfig(mode=TModeConfig(d=8, **SCALE_SKETCH), wire_payloads=True,
                               client_update_clip=clip)
    bad = tengine._quarantine_mask(cfg, torch.from_numpy(norms),
                                   torch.tensor(median, dtype=torch.float32))
    np.testing.assert_array_equal(got, (~bad).numpy().astype(np.float32))


def _fold_inputs(seed, W=8, shape=(3, 7)):
    rs = np.random.RandomState(seed)
    scale = np.logspace(-3, 3, W).reshape(-1, 1, 1).astype(np.float32)
    tables = (rs.randn(W, *shape) * scale).astype(np.float32)
    # -0.0 entries, and where every live table is -0.0 the fold's first
    # add decides the sign
    tables[:, 0, :2] = -0.0
    live = (rs.rand(W) > 0.3).astype(np.float32)
    live[0] = 0.0
    tables[0, 1] = np.nan  # a dead row's NaN contributes zero
    return tables, live


@pytest.mark.parametrize("seed", range(4))
def test_shard_fold_equals_reference_bitwise(seed):
    tables, live = _fold_inputs(seed)
    got = tedge._shard_fold(tables, live)
    want = _jedge()._shard_fold(tables, live)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert np.isfinite(got).all()
    # +0.0 where every live entry was -0.0: the zero the dead rows add
    assert not np.signbit(got[0, :2]).any() or live.sum() == 0


@pytest.mark.parametrize("seed", range(5))
def test_edge_folds_equal_reference_and_per_edge_folds_bitwise(seed):
    import jax
    import jax.numpy as jnp

    from commefficient_tpu.modes import modes as jmodes

    rs = np.random.RandomState(100 + seed)
    E = int(rs.randint(2, 5))
    tables, live = _fold_inputs(seed)
    assign = rs.randint(0, E, len(live)).astype(np.int32)
    grouped = tmodes.edge_grouped_sum(torch.from_numpy(tables), torch.from_numpy(live),
                                      assign, E).numpy()
    jgrouped = np.asarray(jax.jit(jmodes.edge_grouped_sum, static_argnums=3)(
        jnp.asarray(tables), jnp.asarray(live), jnp.asarray(assign), E))
    assert grouped.tobytes() == jgrouped.tobytes()
    # the tree: each edge's host fold over its shard, then the root fold
    partials = np.stack([tedge._shard_fold(tables[assign == e], live[assign == e])
                         for e in range(E)])
    tree = tmodes.merge_edge_partials(torch.from_numpy(partials)).numpy()
    assert tree.tobytes() == grouped.tobytes()
    jtree = np.asarray(jax.jit(jmodes.merge_edge_partials)(jnp.asarray(partials)))
    assert tree.tobytes() == jtree.tobytes()
    # a torch tensor or a list as the assignment gives the same bits
    for a in (torch.from_numpy(assign), assign.tolist()):
        again = tmodes.edge_grouped_sum(torch.from_numpy(tables), torch.from_numpy(live), a, E)
        assert again.numpy().tobytes() == grouped.tobytes()


def test_edge_folds_refuse_bad_shapes():
    with pytest.raises(ValueError, match="n_edges >= 1"):
        tmodes.edge_grouped_sum(torch.zeros(2, 3), torch.ones(2), [0, 0], 0)
    with pytest.raises(ValueError, match="2 edge assignments for 3 tables"):
        tmodes.edge_grouped_sum(torch.zeros(3, 3), torch.ones(3), [0, 1], 2)
    with pytest.raises(ValueError, match=r"\[E, \.\.\.\] partials"):
        tmodes.merge_edge_partials(torch.tensor(1.0))


@pytest.mark.parametrize("forward", [False, True])
def test_edge_tree_round_equals_reference_bitwise(forward):
    jedge = _jedge()
    rs = np.random.RandomState(7)
    ids = np.arange(40, 48)
    tables = rs.randn(8, 3, 5).astype(np.float32)
    tables[2] *= 100.0  # over the screen
    base = np.ones(8, np.float32)
    base[5] = 0.0
    out = []
    for mod in (tedge, jedge):
        tree = mod.EdgeTree(3, (3, 5), forward_tables=forward)
        tree.kill(1)
        dead = tree.dead_positions(ids)
        live = base.copy()
        live[dead] = 0.0
        reports, root = tree.aggregate_round(2, ids, tables, live,
                                             screen=None if forward else (3.0, 1.5))
        out.append((dead, reports, root, tree.dead_edges))
    (tdead, trep, troot, tde), (jdead, jrep, jroot, jde) = out
    np.testing.assert_array_equal(tdead, jdead)
    assert tde == jde == (1,)
    for k in ("assign", "norms"):
        np.testing.assert_array_equal(troot[k], jroot[k])
    if forward:
        assert troot["partials"] is None and jroot["partials"] is None
    else:
        assert troot["partials"].tobytes() == np.asarray(jroot["partials"]).tobytes()
    for a, b in zip(trep, jrep):
        for f in ("edge", "positions", "partial", "tables", "norms", "live", "live_count",
                  "weight_sum"):
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f
    with pytest.raises(ValueError, match="one edge IS the flat merge"):
        tedge.EdgeTree(1, (3, 5))
    with pytest.raises(ValueError, match="out of range"):
        tedge.EdgeTree(2, (3, 5)).kill(2)


def test_edge_tree_counts_and_traces():
    reg = obreg.default()
    mark = reg.mark()
    tree = tedge.EdgeTree(2, (3, 5))
    tree.kill(0)
    tree.aggregate_round(0, np.arange(6), np.ones((6, 3, 5), np.float32),
                         np.ones(6, np.float32))
    assert mark.delta("serve_edge_deaths_total") == 1
    assert mark.delta("serve_edge_partials_total") == 1  # the live edge's
    c = tree.counters()
    assert c["n_edges"] == 2 and c["mode"] == "partial" and c["dead"] == [0]
    assert set(c) == set(_jedge().EdgeTree(2, (3, 5)).counters())
    tree.revive_all()
    assert tree.dead_edges == ()


# ------------------------------------------ THE pin: the tree == flat twin


SETS = [  # tests/test_scale.py:221-226: (clip, shards, edges, quorum, trace seed)
    (0.0, 1, 2, 3, 5),   # quarantine off
    (3.0, 1, 3, 3, 7),   # the quarantine armed, 3 edges
    (3.0, 2, 2, 3, 11),  # a client-sharded session
    (0.0, 1, 4, 2, 13),  # a short quorum: stragglers and no-shows
]


@pytest.mark.parametrize("clip,shards,edges,quorum,trace_seed", SETS)
def test_edge_tree_equals_flat_twin_bitwise_and_the_reference(clip, shards, edges, quorum,
                                                              trace_seed):
    mark = obreg.default().mark()
    sa = _tsession(serve_edges=edges, clip=clip, shards=shards)
    ra, da, svc = _tserve(sa, 4, edges=edges, quorum=quorum, trace_seed=trace_seed)
    assert mark.delta("serve_edge_partials_total") == 4 * edges
    assert svc.metrics_snapshot()["edge"]["n_edges"] == edges
    sb = _tsession(serve_edges=edges, clip=clip, shards=shards)
    rb, db, svc_b = _tserve(sb, 4, edges=0, quorum=quorum, trace_seed=trace_seed)
    assert svc_b.metrics_snapshot()["edge"] is None
    _full_state_equal(sa, sb)
    assert ra == rb and da == db
    assert _requeue(sa) == _requeue(sb)
    assert any(da), "no casualties: the pin is vacuous"
    # against the reference's edge-tree run of the same set
    j = _jscale()._tiny_session(serve_edges=edges, clip=clip, shards=shards)
    jrows, jdrops = _jserve(j, 4, edges, quorum, trace_seed)
    assert jdrops == da
    np.testing.assert_allclose(sa.state["params"].numpy(), _jparams(j), rtol=0, atol=ATOL)
    for t, r in zip(ra, jrows):
        for key in ("clients_dropped", "participants", "requeue_depth"):
            if key in r:
                assert t[key] == r[key], key
        if clip:
            assert t["clients_quarantined"] == r["clients_quarantined"]


def test_edge_armed_session_differs_from_the_plain_merge_only_in_association():
    """An edge-armed session runs another float association than the plain
    merge: its params stay within atol of the unarmed run's."""
    sa = _tsession(serve_edges=3)
    _tserve(sa, 3, edges=3)
    sb = _tsession(serve_edges=0)
    _tserve(sb, 3, edges=0)
    np.testing.assert_allclose(sa.state["params"].numpy(), sb.state["params"].numpy(),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("engine", ["eventloop", "threaded", "shards"])
def test_edge_tree_over_socket_equals_inproc_bitwise(engine):
    extra = ({"socket_transport": "threaded"} if engine == "threaded"
             else {"shards": 2} if engine == "shards" else {})
    sa = _tsession(serve_edges=2)
    ra, da, svc = _tserve(sa, 3, edges=2, transport="socket", **extra)
    sb = _tsession(serve_edges=2)
    rb, db, _ = _tserve(sb, 3, edges=2, transport="inproc")
    _full_state_equal(sa, sb)
    assert ra == rb and da == db
    assert svc.metrics_snapshot()["edge"]["partials"] >= 6


def test_edge_death_equals_shard_dropped_bitwise(capsys):
    E, kill_round, dead_edge = 2, 1, 1
    probe = _tsession(serve_edges=E)
    ids = [probe.sample_cohort(r) for r in range(2)]
    doomed = np.flatnonzero(tedge.assign_edges(ids[kill_round], E) == dead_edge)
    assert len(doomed) > 0, "the hash left the dead edge empty"
    mark = obreg.default().mark()
    sa = _tsession(serve_edges=E, fault_plan=f"edge_kill@{kill_round}:edges={dead_edge}")
    ra, da, svc = _tserve(sa, 3, edges=E, quorum=0)
    err = capsys.readouterr().err
    assert f"serve: edge(s) ({dead_edge},) dead at round {kill_round}" in err
    assert mark.delta("serve_edge_deaths_total") == 1
    assert mark.delta("resilience_fault_edge_kill_total") == 1
    assert svc.metrics_snapshot()["edge"]["deaths"] >= 1
    drop = "+".join(str(int(p)) for p in doomed)
    sb = _tsession(serve_edges=E, fault_plan=f"client_drop@{kill_round}:clients={drop}")
    rb, db, _ = _tserve(sb, 3, edges=E, quorum=0)
    _full_state_equal(sa, sb)
    assert ra == rb and _requeue(sa) == _requeue(sb)
    assert set(doomed) <= set(da[kill_round])
    assert ra[kill_round]["clients_dropped"] >= len(doomed)
    assert ra[kill_round]["requeue_depth"] >= len(doomed)
    # the edge lives again the next round: its clients arrive as in the drop run
    assert da[kill_round + 1] == db[kill_round + 1]


@pytest.mark.parametrize("policy,trim", [("trimmed", 1), ("median", 0)])
def test_robust_policy_runs_forward_mode_bitwise_the_flat_robust_run(capsys, policy, trim):
    sa = _tsession(merge_policy=policy, merge_trim=trim, clip=3.0)
    ra, da, svc = _tserve(sa, 3, edges=2)
    assert "FORWARDS its shard's validated tables" in capsys.readouterr().err
    assert svc.metrics_snapshot()["edge"]["mode"] == "forward"
    sb = _tsession(merge_policy=policy, merge_trim=trim, clip=3.0)
    rb, db, _ = _tserve(sb, 3, edges=0)
    _full_state_equal(sa, sb)
    assert ra == rb and da == db


# ----------------------------------------------------------- validation


def test_edge_config_validation():
    mc = TModeConfig(d=8, **SCALE_SKETCH)
    with pytest.raises(ValueError, match="wire_payloads"):
        tengine.EngineConfig(mode=mc, serve_edges=2)
    with pytest.raises(ValueError, match="serve_edges must be >= 0"):
        tengine.EngineConfig(mode=mc, wire_payloads=True, serve_edges=-1)
    with pytest.raises(ValueError, match="robust"):
        _tsession(serve_edges=2, merge_policy="median")
    with pytest.raises(ValueError, match="buffered-async"):
        tengine.EngineConfig(mode=mc, wire_payloads=True, serve_edges=2, stale_slots=4)
    with pytest.raises(ValueError, match="quarantine_scope='layer'"):
        tengine.EngineConfig(mode=mc, wire_payloads=True, serve_edges=2,
                             client_update_clip=3.0, quarantine_scope="layer")
    # trimmed at trim 0 is the sum: edges arm
    tengine.EngineConfig(mode=mc, wire_payloads=True, serve_edges=2, merge_policy="trimmed")
    s = _tsession(serve_edges=0)
    traffic = ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12))
    base = tservice.ServeConfig(quorum=3, transport="inproc", payload="sketch")
    for cfg, words in (
            (dataclasses.replace(base, edges=2), "serve_edges"),
            (dataclasses.replace(base, payload="announce", edges=2), "announce path has none"),
            (dataclasses.replace(base, edges=1), "one edge IS the flat merge"),
            (dataclasses.replace(base, edges=-2), "one edge IS the flat merge"),
            (dataclasses.replace(base, edges=2, pipeline=True), "does not compose"),
            (dataclasses.replace(base, edges=2, async_mode=True), "does not compose"),
            (dataclasses.replace(base, edges=2, fastpath=True), "--serve_fastpath does not"),
            (dataclasses.replace(base, edges=2, transport="socket", shards=2,
                                 shard_mode="process"), "does not compose with --serve_edges")):
        with pytest.raises(ValueError, match=words):
            tservice.AggregationService(s, cfg, traffic=traffic)
    # an edge-armed session refuses the fast path even without the tree
    with pytest.raises(ValueError, match="--serve_fastpath does not compose"):
        tservice.AggregationService(_tsession(serve_edges=2),
                                    dataclasses.replace(base, fastpath=True), traffic=traffic)
    # a session armed for another E
    with pytest.raises(ValueError, match="needs a session built with serve_edges=3"):
        tservice.AggregationService(_tsession(serve_edges=2),
                                    dataclasses.replace(base, edges=3), traffic=traffic)
    # a robust session armed for edges (built around EngineConfig's check)
    r = _tsession(merge_policy="trimmed", merge_trim=1)
    object.__setattr__(r.cfg, "serve_edges", 2)
    with pytest.raises(ValueError, match="FORWARD mode"):
        tservice.AggregationService(r, dataclasses.replace(base, edges=2), traffic=traffic)
    # an edge block on an unarmed session
    prep = s.prepare_served_round(0, s.sample_cohort(0), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="serve_edges=0"):
        s.finish_served_payload(prep, np.ones(4, np.float32), np.zeros((4, 3, 16), np.float32),
                                (), edge={"assign": [0] * 4, "norms": [0.0] * 4,
                                          "partials": None})
    # the merge variants need an armed config
    with pytest.raises(ValueError, match="edge_input='tables' needs cfg.serve_edges >= 2"):
        tengine.make_payload_round_steps(_tquad, s.cfg, s.layout, edge_input="tables")
    with pytest.raises(ValueError, match="edge_input must be none|tables|partials"):
        tengine.make_payload_round_steps(_tquad, s.cfg, s.layout, edge_input="roots")


def test_edge_kill_fault_kind_equals_reference():
    from commefficient_tpu.resilience import FaultPlan as JFaultPlan

    assert tfaults.NOT_PORTED == {}
    text = "edge_kill@1,3:edges=0+2;edge_kill@3:edges=1"
    t, j = TFaultPlan.parse(text), JFaultPlan.parse(text)
    for rnd in range(5):
        assert t.edge_kill_plan(rnd) == j.edge_kill_plan(rnd)
    assert t.has_edge_kill() and j.has_edge_kill()
    for plan in (t, j):
        with pytest.raises(ValueError, match="edge_kill can never fire"):
            plan.validate_edge_context(False)
        with pytest.raises(ValueError, match=r"edges=2 can never fire .* 2 edge\(s\)"):
            plan.validate_edge_context(True, n_edges=2)
        plan.validate_edge_context(True, n_edges=3)
        with pytest.raises(ValueError, match="edge_kill@5 can never fire"):
            type(plan).parse("edge_kill@5:edges=0").validate_rounds(5)
    for mod in (TFaultPlan, JFaultPlan):
        with pytest.raises(ValueError, match="'edge_kill' needs edges="):
            mod.parse("edge_kill@1")
        with pytest.raises(ValueError, match="non-negative edge indices"):
            mod.parse("edge_kill@1:edges=-1")
    assert TFaultPlan.parse("client_drop@1:clients=0").validate_edge_context(False) is None


CV = ["--dataset", "cifar10", "--mode", "sketch", "--data_root", "/nonexistent",
      "--num_rounds", "1", "--device", "cpu"]
# (the command line, the reference's words)
CLI_REFUSALS = {
    "one_edge": (["--serve", "inproc", "--serve_payload", "sketch", "--serve_edges", "1"],
                 "one edge IS the flat merge"),
    "negative": (["--serve", "inproc", "--serve_payload", "sketch", "--serve_edges", "-2"],
                 "must be >= 2"),
    "serve_off": (["--serve_edges", "2"], "is a serving topology; arm --serve"),
    "announce": (["--serve", "inproc", "--serve_edges", "2"], "serve_payload sketch"),
    "pipeline": (["--serve", "inproc", "--serve_payload", "sketch", "--serve_edges", "2",
                  "--serve_pipeline"], "does not compose"),
    "async": (["--serve", "inproc", "--serve_payload", "sketch", "--serve_edges", "2",
               "--serve_async"], "does not compose"),
    "fastpath": (["--serve", "inproc", "--serve_payload", "sketch", "--serve_edges", "2",
                  "--serve_fastpath"], "--serve_fastpath does not compose with --serve_edges"),
    "process": (["--serve", "socket", "--serve_payload", "sketch", "--serve_shards", "2",
                 "--serve_shard_mode", "process", "--serve_edges", "2"],
                "--serve_shard_mode process does not compose"),
}


@pytest.mark.parametrize("task", ["cv", "gpt2"])
@pytest.mark.parametrize("case", list(CLI_REFUSALS))
def test_cli_edge_refusals_in_the_reference_words(case, task):
    from commefficient_tpu.utils.config import make_parser as jmake_parser
    from commefficient_tpu.utils.config import resolve_defaults as jresolve

    argv, words = CLI_REFUSALS[case]
    argv = ["--mode", "sketch", *argv]
    with pytest.raises(SystemExit, match=words) as mine:
        resolve_defaults(make_parser(task).parse_args(argv))
    with pytest.raises(SystemExit) as ref:
        jresolve(jmake_parser(task).parse_args(argv))
    # the same refusal, in the same words (dashes aside)
    assert str(mine.value).replace(" - ", " — ") == str(ref.value)


@pytest.mark.parametrize("task", ["cv", "gpt2"])
def test_cli_accepts_serve_edges_and_arms_the_session(task):
    args = resolve_defaults(make_parser(task).parse_args(
        ["--mode", "sketch", "--serve", "inproc", "--serve_payload", "sketch",
         "--serve_edges", "3"]))
    assert tservice.ServeConfig.from_args(args).edges == 3
    assert make_parser(task).parse_args([]).serve_edges == 0


def test_cli_refuses_edge_kill_on_a_flat_run_before_any_round(tiny_cv, monkeypatch):  # noqa: F811
    ran = []
    monkeypatch.setattr(cv_train, "run_loop", lambda *a, **kw: ran.append(1))
    with pytest.raises(ValueError, match="edge_kill can never fire"):
        cv_train.main(CV + ["--serve", "inproc", "--fault_plan", "edge_kill@0:edges=0"])
    with pytest.raises(ValueError, match="can never fire - the tree has 2 edge"):
        cv_train.main(CV + ["--serve", "inproc", "--serve_payload", "sketch", "--serve_edges",
                            "2", "--fault_plan", "edge_kill@0:edges=2"])
    assert not ran


# ------------------------------------------------------------- the CLIs


CLI = ["--dataset", "cifar10", "--mode", "sketch", "--k", "16", "--num_rows", "3",
       "--num_cols", "128", "--num_clients", "8", "--num_workers", "4",
       "--local_batch_size", "4", "--num_rounds", "4", "--lr_scale", "0.05",
       "--weight_decay", "0", "--data_root", "/nonexistent", "--seed", "3", "--device", "cpu",
       "--serve", "inproc", "--serve_payload", "sketch", "--serve_quorum", "3",
       "--serve_deadline", "2.0", "--serve_edges", "2", "--sync_loop"]


def _flat_twin(monkeypatch):
    """Serve the CLIs' edge-armed sessions without the tree."""
    orig = tservice.ServeConfig.from_args.__func__
    monkeypatch.setattr(tservice.ServeConfig, "from_args", classmethod(
        lambda cls, args: dataclasses.replace(orig(cls, args), edges=0)))


def test_cli_edge_tree_equals_flat_twin(tiny_cv, monkeypatch, capsys):  # noqa: F811
    sa = cv_train.main(list(CLI))
    out = capsys.readouterr().out
    assert "2-edge tree" in out and "'edge': {'n_edges': 2" in out
    assert sa.cfg.serve_edges == 2
    _flat_twin(monkeypatch)
    sb = cv_train.main(list(CLI))
    assert "'edge': None" in capsys.readouterr().out
    _assert_state_equal(sa, sb)
    assert list(sa._requeue) == list(sb._requeue)


def test_cli_edge_tree_preempt_resume_bitwise(tiny_cv, tmp_path):  # noqa: F811
    sa = cv_train.main(list(CLI))
    ck = str(tmp_path / "ck")
    chaos = ["--checkpoint_dir", ck, "--checkpoint_every", "1", "--fault_plan", "preempt@2"]
    with pytest.raises(SystemExit) as ei:
        cv_train.main(list(CLI) + chaos)
    assert ei.value.code == EXIT_RESUMABLE
    sc = cv_train.main(list(CLI) + chaos + ["--resume"])
    assert sc.round == 4
    _assert_state_equal(sa, sc)
    assert list(sa._requeue) == list(sc._requeue)


GPT2_CLI = ["--model_size", "tiny", "--seq_len", "16", "--num_clients", "8",
            "--num_workers", "4", "--local_batch_size", "2", "--num_rounds", "2",
            "--eval_every", "2", "--eval_batch_size", "8", "--data_root", "/nonexistent",
            "--device", "cpu", "--mode", "sketch", "--k", "100", "--num_cols", "2000",
            "--serve", "inproc", "--serve_payload", "sketch", "--serve_deadline", "30",
            "--serve_edges", "2", "--sync_loop"]


def test_gpt2_cli_edge_tree_equals_flat_twin(monkeypatch, capsys):
    mark = obreg.default().mark()
    sa = gpt2_train.main(list(GPT2_CLI))
    assert "2-edge tree" in capsys.readouterr().out
    assert mark.delta("serve_edge_partials_total") == 4
    assert sa.round == 2 and torch.isfinite(sa.state["params"]).all()
    _flat_twin(monkeypatch)
    sb = gpt2_train.main(list(GPT2_CLI))
    _assert_state_equal(sa, sb)


# ---------------------------------------------------------- on a group


WORLD, GROUP_W = 4, 8
GROUP_PAYLOAD = tservice.ServeConfig(quorum=8, deadline_s=30.0, payload="sketch")
GROUP_CASES = {
    # name -> (session knobs, service config)
    "tree": (dict(wire_payloads=True, client_update_clip=3.0, serve_edges=2,
                  fault_plan="wire_corrupt@1:clients=0;edge_kill@2:edges=1"),
             dataclasses.replace(GROUP_PAYLOAD, edges=2)),
    "flat_twin": (dict(wire_payloads=True, client_update_clip=3.0, serve_edges=2,
                       fault_plan="wire_corrupt@1:clients=0"), GROUP_PAYLOAD),
    "forward": (dict(wire_payloads=True, merge_policy="trimmed", merge_trim=1),
                dataclasses.replace(GROUP_PAYLOAD, edges=2)),
}


def _edge_ranks(out_dir):
    distributed.initialize(force=True, device="cpu")
    rank = dist.get_rank()
    got = {}
    for name, (kw, cfg) in GROUP_CASES.items():
        s = _group_session(16, GROUP_SKETCH, mesh=MESH, **kw)
        sizes = []
        broadcast = distributed.broadcast_from_root

        def sized(tensors, group=None):
            sizes.append(sum(t.numel() * t.element_size() for t in tensors))
            return broadcast(tensors, group)

        distributed.broadcast_from_root = sized
        try:
            metrics, svc = _group_serve(s, cfg)
        finally:
            distributed.broadcast_from_root = broadcast
        got[name] = dict(_snap(s, metrics, svc), sizes=sizes)
        svc.close()
    torch.save(got, os.path.join(out_dir, f"edge_{rank}.pt"))


@pytest.fixture(scope="module")
def edge_group(tmp_path_factory):
    out = tmp_path_factory.mktemp("edge_group")
    codes = distributed.launch_local(_edge_ranks, WORLD, (str(out),), timeout_s=300)
    assert codes == [0] * WORLD, codes
    return [torch.load(out / f"edge_{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_group_edge_serve_equals_the_one_device_run_bitwise(edge_group, name):
    from test_torch_distributed import _equal

    kw, cfg = GROUP_CASES[name]
    t = _twin(GROUP_SKETCH, **kw)
    metrics, svc = _group_serve(t, cfg)
    svc.close()
    for r, got in enumerate(edge_group):
        g = got[name]
        _equal(g["state"], {k: v for k, v in t.state.items() if k != "round"}, f"{name} {r}")
        assert g["metrics"] == metrics, (name, r)
        assert g["requeue"] == _snap(t, metrics)["requeue"], (name, r)
        assert g["round"] == t.round
    assert edge_group[0][name]["counters"] == svc.queue.counters()
    sizes = edge_group[0][name]["sizes"]
    table = 4 * GROUP_SKETCH["num_rows"] * GROUP_SKETCH["num_cols"]
    if name == "tree":
        # the mask, the norms, the assignment and E = 2 partials a round
        assert sizes == [GROUP_W * 12 + 2 * table] * len(sizes) and sizes
        assert any(m["clients_dropped"] for m in metrics)
    elif name == "flat_twin":
        assert sizes == [GROUP_W * 12 + GROUP_W * table] * len(sizes) and sizes
    else:
        assert sizes == [GROUP_W * 4 + GROUP_W * table] * len(sizes) and sizes
