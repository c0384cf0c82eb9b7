"""The sharded ingest over reactor threads (``--serve_shards N
--serve_shard_mode thread``, ``commefficient_tpu_torch/serve/scale/
shard.py``), the reactors' per-shard series (``scale/eventloop.py``) and
the launch refusals of both shard modes, on the CPU.

Against the JAX package:

- ``shard_for`` equals the reference's exactly, for 100,000 ids at n in
  {2, 3, 4, 7}, scalar and vectorized;
- the reference's shard pins of tests/test_scale.py (:480, :531, :557,
  :581, :599, :629), each on the port's reactors and service;
- a thread-sharded served payload run (fast path off and on) against the
  reference's one-listener socket run of the same session and trace: the
  same casualties, counters and requeue, the params within atol 1e-5 (the
  served pins' tolerance: the packages add clients in another float
  order);
- every launch refusal of the shard flags (both CLIs' and the service's),
  with the reference's words.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import test_serve as jserve
from commefficient_tpu.serve.scale import shard as jshard
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.serve.ingest import (ACCEPTED, DUPLICATE, SHEDDING, IngestQueue,
                                                  Submission)
from commefficient_tpu_torch.serve.metrics import render_prometheus
from commefficient_tpu_torch.serve.scale.eventloop import EventLoopTransport
from commefficient_tpu_torch.serve.scale.shard import ShardedIngest, shard_for
from commefficient_tpu_torch.serve.transport import submit_over_socket
from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults
from test_torch_fastpath import ATOL, LR, PLAN, RELIABLE, _jparams, _quad_paths, _tparams  # noqa: F401
from test_torch_fastpath import _tsession

torch.set_num_threads(2)


def _sub(cid, rnd=0):
    return Submission(client_id=cid, round=rnd, latency_s=0.1)


def _traffic():
    return ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12, seed=5),
                                     classes=RELIABLE)


def trun(session, cfg, rounds):
    """``rounds`` served payload rounds of the port's service: (the closed
    service, the dropped positions of each round)."""
    svc = tservice.AggregationService(session, cfg, traffic=_traffic()).start()
    src, drops = svc.source(), []
    try:
        for _ in range(rounds):
            prep = src.next()
            drops.append(sorted(int(p) for p in np.flatnonzero(prep.payload[1] == 0.0)))
            session.commit_round(session.dispatch_round(prep, LR))
    finally:
        svc.close()
    return svc, drops


# ------------------------------------------------------- routing: shard_for


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_shard_for_equals_reference_bitwise(n):
    ids = np.arange(100_000, dtype=np.int64) * 7919 + 3
    got = shard_for(ids, n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jshard.shard_for(ids, n))
    for cid in ids[:200:7]:
        assert shard_for(int(cid), n) == jshard.shard_for(int(cid), n)
        assert isinstance(shard_for(int(cid), n), int)
    assert set(np.unique(got)) == set(range(n))


def test_shard_for_partitions_every_client():
    ids = np.arange(5000, 5200)
    owners = {int(cid): shard_for(int(cid), 4) for cid in ids}
    assert set(owners.values()) <= set(range(4)) and len(set(owners.values())) > 1
    for cid in ids[:20]:
        assert shard_for(int(cid), 4) == owners[int(cid)]
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        shard_for(1, 0)


# ------------------------------------- the reference's shard pins (test_scale)


def test_standalone_reactor_publishes_no_shard_series():
    q = IngestQueue(capacity=8)
    t = EventLoopTransport(q, read_deadline_s=2.0)
    t.start()
    try:
        q.open_round(0, [1])
        before = obreg.default().snapshot().get("serve_shard0_conns")
        assert submit_over_socket(t.address, _sub(1)) == ACCEPTED
        time.sleep(0.1)
        assert obreg.default().snapshot().get("serve_shard0_conns") == before
        assert t.addr_for(12345) == t.address
    finally:
        t.stop()
        q.shutdown()


def test_sharded_ingest_routes_and_counts():
    q = IngestQueue(capacity=64)
    tr = ShardedIngest(q, n_shards=2, read_deadline_s=2.0)
    tr.start()
    try:
        before = tr.counters()
        ids = list(range(40, 72))
        q.open_round(0, ids)
        for cid in ids:
            assert tr.submit(_sub(cid)) == ACCEPTED
        assert q.counters()["accepted"] == len(ids)
        counts = tr.counters()
        per_shard = [counts[str(k)]["submissions"] - before[str(k)]["submissions"]
                     for k in range(2)]
        assert sum(per_shard) == len(ids) and all(c > 0 for c in per_shard), per_shard
        assert per_shard[1] == sum(shard_for(c, 2) for c in ids)
        assert all(counts[str(k)]["misrouted"] == before[str(k)]["misrouted"] for k in range(2))
        # a misrouted submission is decided right, and counted
        cid = ids[0]
        wrong = tr.shards[1 - shard_for(cid, 2)]
        assert submit_over_socket(wrong.address, _sub(cid)) == DUPLICATE
        after = tr.counters()
        assert sum(after[str(k)]["misrouted"] - before[str(k)]["misrouted"]
                   for k in range(2)) == 1
    finally:
        tr.stop()
        q.shutdown()


def test_sharded_shedding_hint_is_per_shard():
    """A shed reply carries the shard's load-scaled retry-after hint, and
    the shard's own shed counter and hint gauge move."""
    q = IngestQueue(capacity=4, pending_capacity=0, shed_watermark=0.25, shed_retry_after_s=1.0)
    tr = ShardedIngest(q, n_shards=2, read_deadline_s=2.0)
    tr.start()
    try:
        before = tr.counters()
        ids = list(range(8))
        q.open_round(0, ids)
        statuses = [tr.submit(_sub(cid)) for cid in ids]
        assert SHEDDING in statuses
        counts = tr.counters()
        shed = [counts[str(k)]["shed"] - before[str(k)]["shed"] for k in range(2)]
        assert sum(shed) == statuses.count(SHEDDING)
        assert all(counts[str(k)]["retry_after_s"] >= 1.0 for k in range(2) if shed[k])
    finally:
        tr.stop()
        q.shutdown()


def test_shard_metrics_reach_prometheus_exposition():
    q = IngestQueue(capacity=16)
    tr = ShardedIngest(q, n_shards=2, read_deadline_s=2.0)
    tr.start()
    try:
        q.open_round(0, [1, 2])
        tr.submit(_sub(1))
        body = render_prometheus()
        for k in range(2):
            assert f"serve_shard{k}_submissions_total" in body
            assert f"serve_shard{k}_conns" in body
    finally:
        tr.stop()
        q.shutdown()


def test_sharded_service_end_to_end_metrics():
    """A served payload run over thread shards commits its rounds, and
    ``/metrics`` carries the shards block."""
    s = _tsession()
    cfg = tservice.ServeConfig(quorum=3, transport="socket", payload="sketch", shards=2,
                               metrics_port=0)
    svc = tservice.AggregationService(s, cfg, traffic=_traffic()).start()
    try:
        src = svc.source()
        for _ in range(2):
            s.commit_round(s.dispatch_round(src.next(), LR))
            src.on_committed(s.round)
        src.stop()
        host, port = svc.metrics_server.address
        snap = json.loads(urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                                 timeout=10).read())
        assert snap["transport_engine"] == "eventloop" and snap["shard_mode"] == "thread"
        assert set(snap["shards"]) == {"0", "1"} and snap["shard_deaths"] is None
        assert sum(v["submissions"] for v in snap["shards"].values()) > 0
    finally:
        svc.close()
    assert s.round == 2


def test_shard_transport_config_validation():
    with pytest.raises(ValueError, match="n_shards must be >= 2"):
        ShardedIngest(IngestQueue(capacity=4), n_shards=1)
    s = _tsession()
    with pytest.raises(ValueError, match="eventloop"):
        tservice.AggregationService(s, tservice.ServeConfig(
            quorum=3, transport="socket", payload="sketch", socket_transport="threaded",
            shards=2), traffic=_traffic())
    with pytest.raises(ValueError, match="no connections to shard"):
        tservice.AggregationService(s, tservice.ServeConfig(
            quorum=3, transport="inproc", payload="sketch", shards=2), traffic=_traffic())
    svc = tservice.AggregationService(s, tservice.ServeConfig(
        quorum=3, transport="socket", payload="sketch", shards=2, max_conns=7),
        traffic=_traffic())
    try:
        assert [t.max_conns for t in svc.transport.shards] == [7, 7]
    finally:
        svc.close()


# ------------------------------------------ served runs against the reference


@pytest.mark.parametrize("fastpath", [False, True])
def test_thread_sharded_run_matches_reference_one_listener(fastpath):
    from commefficient_tpu.resilience import FaultPlan as JFaultPlan

    j = jserve._sketch_session(fault_plan=JFaultPlan.parse(PLAN), clip=3.0)
    jsvc, jdrops = jserve._serve_payload_rounds(j, 3, transport="socket", quorum=4,
                                                deadline=30.0)
    t = _tsession(fault_plan=PLAN, clip=3.0)
    tsvc, tdrops = trun(t, tservice.ServeConfig(quorum=4, deadline_s=30.0, transport="socket",
                                                payload="sketch", shards=3, fastpath=fastpath),
                        3)
    assert tdrops == jdrops and any(tdrops)
    assert tsvc.queue.counters() == jsvc.queue.counters()
    assert list(t._requeue) == list(j._requeue)
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)


# ----------------------------------------------------- the launch refusals

SOCKET = ["--serve", "socket", "--serve_payload", "sketch", "--mode", "sketch"]
# (the command line, the reference's words)
REFUSALS = {
    "process_async": (SOCKET + ["--serve_shards", "2", "--serve_shard_mode", "process",
                                "--serve_async"], "does not compose with"),
    "process_pipeline": (SOCKET + ["--serve_shards", "2", "--serve_shard_mode", "process",
                                   "--serve_pipeline"], "does not compose with"),
    "process_edges": (SOCKET + ["--serve_shards", "2", "--serve_shard_mode", "process",
                                "--serve_edges", "2"], "does not compose with"),
    "process_no_shards": (SOCKET + ["--serve_shard_mode", "process"],
                          "process needs --serve_shards >= 2"),
    "process_one_shard": (SOCKET + ["--serve_shards", "1", "--serve_shard_mode", "process"],
                          "--serve_shards must be >= 2"),
    "shards_inproc": (["--serve", "inproc", "--serve_shards", "2"],
                      "shards the socket ingest; arm --serve socket"),
    "shards_threaded": (SOCKET + ["--serve_shards", "2", "--serve_transport", "threaded"],
                        "arm --serve_transport eventloop"),
}


@pytest.mark.parametrize("task", ["cv", "gpt2"])
@pytest.mark.parametrize("case", list(REFUSALS))
def test_cli_launch_refusals_in_the_reference_words(case, task):
    argv, words = REFUSALS[case]
    with pytest.raises(SystemExit, match=words):
        resolve_defaults(make_parser(task).parse_args(argv))


def test_cli_takes_both_shard_modes():
    for mode in ("thread", "process"):
        args = resolve_defaults(make_parser().parse_args(
            SOCKET + ["--serve_shards", "3", "--serve_shard_mode", mode, "--serve_fastpath"]))
        cfg = tservice.ServeConfig.from_args(args)
        assert (cfg.shards, cfg.shard_mode, cfg.fastpath) == (3, mode, True)


SERVICE_REFUSALS = {
    "process_async": (dict(shards=2, shard_mode="process", async_mode=True, buffer_size=2),
                      "does not compose with --serve_async"),
    "process_pipeline": (dict(shards=2, shard_mode="process", pipeline=True),
                         "does not compose with --serve_pipeline"),
    "process_no_shards": (dict(shards=0, shard_mode="process"),
                          "process needs --serve_shards >= 2"),
    "negative_shards": (dict(shards=-1), "--serve_shards must be >= 0"),
    "bad_mode": (dict(shards=2, shard_mode="fork"), "must be thread\\|process"),
}


@pytest.mark.parametrize("case", list(SERVICE_REFUSALS))
def test_service_refusals_in_the_reference_words(case):
    kw, words = SERVICE_REFUSALS[case]
    s = _tsession(stale_slots=2)
    with pytest.raises(ValueError, match=words):
        tservice.AggregationService(s, tservice.ServeConfig(
            quorum=3, transport="socket", payload="sketch", **kw), traffic=_traffic())
