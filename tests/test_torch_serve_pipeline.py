"""The always-on serving pipeline (``--serve_pipeline``,
``commefficient_tpu_torch/serve/pipeline.py``) and the port's served
rounds at ``client_shards`` S, on the CPU.

Against the JAX package, on the quad-loss model of tests/test_serve.py and
tests/test_pipeline_serve.py, built in both with the same parameters and
data:

- the one-device served rounds at ``client_shards`` 2 and 4, announce
  (quorum 2 of 4 within 1 s) and payload (the clip, a corrupt, a
  duplicated and a NaN-poisoned client: tests/test_serve.py's sessions at
  :393 and :947): invite lists, arrival masks, closes, requeue and ages
  equal, client tables within rtol 1e-5, atol 1e-6 and params within atol
  1e-5 (tests/test_torch_serve.py's tolerances: the packages add clients in
  another float order);
- pipelined runs (tests/test_pipeline_serve.py:450-526): announce, payload,
  through the async run loop and a session reused after a stopped loop,
  each within the same tolerance of the reference's pipelined run, and the
  CV CLI pipelined, preempted at round 1 and resumed, within atol 1e-5 of
  the reference CLI's (:712).

Within the port, bitwise: pipelined equals serial in announce and payload
rounds (in process, and the payload over the socket), through the run loop (which measures ``server_idle_ms``), for a
session reused after a stopped loop, and for the CLI preempted and
resumed; the worker thread is gone after every stop."""

import collections
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import cv_train as jcv
import test_pipeline_serve as jpipe
import test_serve as jserve
from commefficient_tpu.serve import clients as jclients
from commefficient_tpu.serve import service as jservice
from commefficient_tpu.serve import traffic as jtraffic
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.federated.api import FedOptimizer
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.runner.loop import RunnerConfig, run_loop
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from test_torch_loop_parity import _run_with_resume, both_tiny  # noqa: F401
from test_torch_runner import _assert_state_equal
from test_torch_serve import (ATOL, RELIABLE, SKETCH, UNCOMPRESSED, _data, _jparams, _Quad,
                              _serve, _tparams, _tquad)

torch.set_num_threads(2)

LR = 0.05
JRELIABLE = (jclients.DeviceClass("lab", weight=1.0, latency_median_s=0.1,
                                  latency_sigma=0.1, no_show_prob=0.0),)
PAYLOAD_PLAN = ("wire_corrupt@1:clients=0;wire_dup@1:clients=1;"
                "client_poison@2:clients=3,value=nan")
# tests/test_pipeline_serve.py's payload sketch
SKETCH16 = dict(mode="sketch", k=4, num_rows=3, num_cols=16, momentum=0.9,
                momentum_type="virtual", error_type="virtual")


@pytest.fixture()
def quad(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", {"w": ("w",), "b": ("b",)}.__getitem__)


def _tsession(mode, shards=0, fault_plan=None, wire=False, clip=0.0):
    """The port's twin of the reference test sessions (``_tiny_session``,
    ``_sketch_session``): the quad model, 12 clients, W = 4."""
    x, y, w0 = _data()
    train = TFedDataset(x, y, tshard_iid(len(x), 12, np.random.RandomState(1)))
    model = _Quad(w0)
    layout = convert.FlatLayout(model)
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(model.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(d=layout.d, **mode), train_set=train, num_workers=4,
                    local_batch_size=4, seed=0, fault_plan=TFaultPlan.parse(fault_plan),
                    device="cpu", wire_payloads=wire, client_update_clip=clip,
                    client_shards=shards)


# ------------------------------------------- client_shards S against the reference


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("payload", ["announce", "sketch"])
def test_one_device_served_rounds_at_shards_match_jax(quad, payload, shards):
    if payload == "announce":
        j = jserve._tiny_session(shards=shards)
        t = _tsession(UNCOMPRESSED, shards)
        kw = dict(quorum=2, deadline=1.0)
        jkw = tkw = {}
    else:
        j = jserve._sketch_session(shards=shards, fault_plan=jserve._FP.parse(PAYLOAD_PLAN),
                                   clip=3.0)
        t = _tsession(SKETCH, shards, PAYLOAD_PLAN, wire=True, clip=3.0)
        kw = dict(quorum=4, deadline=30.0, payload="sketch")
        jkw, tkw = {"classes": JRELIABLE}, {"classes": RELIABLE}
    assert t.cfg.client_shards == shards
    jrec, jtables, jsvc = _serve(j, jservice, jtraffic, 3, **kw, **jkw)
    trec, ttables, tsvc = _serve(t, tservice, ttraffic, 3, **kw, **tkw)
    assert trec == jrec  # cohorts, arrivals, closes, requeue and ages
    assert any(0.0 in arr for _, arr, *_ in trec), "no casualties: the pin is vacuous"
    for tt, jt in zip(ttables, jtables, strict=True):
        np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_tparams(t), _jparams(j), atol=ATOL)
    if payload == "sketch":
        tc, jc = tsvc.queue.counters(), jsvc.queue.counters()
        for k in ("rejected_malformed", "rejected_dup", "rejected_quarantined"):
            assert tc[k] == jc[k] >= 1, (k, tc, jc)


# ----------------------------------------------------------- pipelined, port


def _pserve(session, cfg, rounds):
    """``rounds`` served rounds in the run loop's dispatch shape (next ->
    dispatch -> on_dispatched -> commit -> on_committed), then the loop's
    exit rewind; returns the metric rows. The twin of the reference test's
    ``_serve``."""
    svc = tservice.AggregationService(
        session, cfg, traffic=ttraffic.TrafficGenerator(
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


def _workers() -> list:
    return [t for t in threading.enumerate() if t.name == "serve-pipeline"]


ANNOUNCE = tservice.ServeConfig(quorum=2, deadline_s=1.0)
PAYLOAD = tservice.ServeConfig(quorum=2, deadline_s=1.0, payload="sketch")


@pytest.mark.parametrize("payload", ["announce", "sketch", "sketch_socket"])
def test_pipelined_bitwise_equals_serial(quad, payload):
    mode, cfg = (UNCOMPRESSED, ANNOUNCE) if payload == "announce" else (SKETCH16, PAYLOAD)
    wire = payload != "announce"
    a = _tsession(mode, wire=wire)
    ra = _pserve(a, cfg, 4)
    b = _tsession(mode, wire=wire)
    # the socket: every table round-trips the loopback wire from the worker
    sock = {"transport": "socket"} if payload == "sketch_socket" else {}
    rb = _pserve(b, dataclasses.replace(cfg, pipeline=True, **sock), 4)
    assert ra == rb
    _assert_state_equal(a, b)
    assert list(a._requeue) == list(b._requeue) and a._requeue_enqueued == b._requeue_enqueued
    assert not _workers()


def _loop(s, cfg, totals, sync=False):
    """The served run loop to each of ``totals`` in turn, on one session
    and one service; the RunStats of each loop."""
    svc = tservice.AggregationService(
        s, cfg, traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12,
                                                                        seed=5))).start()
    try:
        opt = FedOptimizer(lambda e: LR, 3)
        return [run_loop(s, opt, RunnerConfig(total_rounds=n, eval_every=100, sync_loop=sync),
                         source=svc.source()) for n in totals]
    finally:
        svc.close()


@pytest.mark.parametrize("payload", ["announce", "sketch"])
def test_pipelined_run_loop_bitwise_serial_and_idle_measured(quad, payload):
    mode, cfg = (UNCOMPRESSED, ANNOUNCE) if payload == "announce" else (SKETCH16, PAYLOAD)
    wire = payload == "sketch"
    a = _tsession(mode, wire=wire)
    (sa,) = _loop(a, cfg, [5], sync=True)
    b = _tsession(mode, wire=wire)
    (sb,) = _loop(b, dataclasses.replace(cfg, pipeline=True), [5])
    _assert_state_equal(a, b)
    assert sa.rounds == sb.rounds == 5 and not _workers()
    assert list(a._requeue) == list(b._requeue) and a._requeue_enqueued == b._requeue_enqueued
    for st in (sa, sb):
        assert 0.0 < st.server_idle_ms <= st.server_idle_ms_max


def test_pipelined_session_reuse_after_a_stop(quad):
    """A pipelined loop that stops at round 2 (its worker has served rounds
    that never commit) rewinds; a second loop on the same session and
    service continues bitwise the uninterrupted serial run."""
    a = _tsession(UNCOMPRESSED)
    _loop(a, dataclasses.replace(ANNOUNCE, pipeline=True), [2, 5])
    b = _tsession(UNCOMPRESSED)
    _pserve(b, ANNOUNCE, 5)
    assert a.round == b.round == 5
    _assert_state_equal(a, b)
    assert list(a._requeue) == list(b._requeue)


# ------------------------------------------------- pipelined, the reference


@pytest.mark.parametrize("payload", ["announce", "sketch"])
def test_pipelined_rounds_match_jax(quad, payload):
    mode, cfg = (UNCOMPRESSED, ANNOUNCE) if payload == "announce" else (SKETCH16, PAYLOAD)
    wire = payload == "sketch"
    j = jpipe._tiny_session(payload=wire)
    jrows = jpipe._serve(j, jservice.ServeConfig(quorum=2, deadline_s=1.0, pipeline=True,
                                                 payload=cfg.payload), 4)
    t = _tsession(mode, wire=wire)
    trows = _pserve(t, dataclasses.replace(cfg, pipeline=True), 4)
    for jr, tr in zip(jrows, trows, strict=True):
        for k in ("participants", "clients_dropped", "count"):
            if k in jr:
                assert tr[k] == float(jr[k]), (k, tr, jr)
        assert tr["loss_sum"] == pytest.approx(float(jr["loss_sum"]), rel=1e-5)
    np.testing.assert_allclose(_tparams(t), _jparams(j), atol=ATOL)
    assert list(t._requeue) == [int(c) for c in j._requeue]


def test_pipelined_run_loop_and_reuse_match_jax(quad):
    """The reference's run-loop and reuse pins (the async loop to 2, then
    to 5, on one pipelined service) against the port's."""
    j = jpipe._tiny_session()
    svc = jservice.AggregationService(
        j, jservice.ServeConfig(quorum=2, deadline_s=1.0, pipeline=True),
        traffic=jtraffic.TrafficGenerator(jtraffic.TraceConfig(population=12, seed=5))).start()
    try:
        from commefficient_tpu.federated.api import FedOptimizer as JOpt
        from commefficient_tpu.runner.loop import RunnerConfig as JRunnerConfig
        from commefficient_tpu.runner.loop import run_loop as jrun_loop

        opt = JOpt(lambda e: LR, 3)
        for n in (2, 5):
            jrun_loop(j, opt, JRunnerConfig(total_rounds=n, eval_every=100),
                      source=svc.source())
    finally:
        svc.close()
    t = _tsession(UNCOMPRESSED)
    _loop(t, dataclasses.replace(ANNOUNCE, pipeline=True), [2, 5])
    assert t.round == j.round == 5
    np.testing.assert_allclose(_tparams(t), _jparams(j), atol=ATOL)


# ---------------------------------------------------------------------- CLI

PIPE_CLI = ["--dataset", "cifar10", "--mode", "uncompressed", "--num_clients", "8",
            "--num_workers", "2", "--local_batch_size", "4", "--lr_scale", "0.05",
            "--data_root", "/nonexistent", "--num_rounds", "4", "--eval_every", "2",
            "--serve", "inproc", "--serve_pipeline", "--serve_quorum", "2",
            "--serve_deadline", "2.0"]


def test_cli_pipelined_preempt_resume_bitwise_and_matches_jax(both_tiny, tmp_path):  # noqa: F811
    ts = _run_with_resume(tcv.main, PIPE_CLI + ["--device", "cpu"], str(tmp_path / "tck"))
    # the same run serial and uninterrupted
    serial = [a for a in PIPE_CLI if a != "--serve_pipeline"]
    tu = tcv.main(serial + ["--device", "cpu", "--sync_loop"])
    assert ts.round == tu.round == 4 and not _workers()
    _assert_state_equal(ts, tu)
    assert list(ts._requeue) == list(tu._requeue)
    js = _run_with_resume(jcv.main, PIPE_CLI + ["--sync_loop", "--num_devices", "1"],
                          str(tmp_path / "jck"))
    assert js.round == 4
    jp = np.asarray(ravel_pytree(jax.device_get(js.state["params"]))[0])
    np.testing.assert_allclose(ts.state["params"].numpy(), jp, rtol=0, atol=1e-5)
    assert ts.comm_mb_total == pytest.approx(js.comm_mb_total, rel=1e-12)
