"""The port's aggregation service (``commefficient_tpu_torch/serve/``).

Against the JAX package, on tests/test_serve.py's quad-loss model built in
both with the same parameters and data: for 3 served rounds the invite
lists, arrival masks, closes, requeue and ages are equal, and the params
agree within atol 1e-5 (the tolerance of tests/test_torch_round.py: the
two packages add clients in another float order). The payload round's
per-client tables agree within rtol 1e-5, atol 1e-6, and so do its params.

Within the port, bitwise: a served round equals the batch round that
drops the same positions (announce and payload), a full-arrival round the
plain round, the socket the in-process transport and the event loop the
threaded engine; a CLI run preempted mid-run resumes to the uninterrupted
run (announce and payload), with its pending queue and requeue ages from
meta.json; the flags of ROADMAP item 9b are refused by name, and a
stopped transport fails the round."""

import json
import os
import socket
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.data.fed_dataset import FedDataset as JFedDataset
from commefficient_tpu.data.fed_dataset import shard_iid as jshard_iid
from commefficient_tpu.federated.api import FederatedSession as JSession
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu.serve import service as jservice
from commefficient_tpu.serve import traffic as jtraffic
from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.serve import clients as tclients
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.serve.ingest import BUFFERED, Submission
from commefficient_tpu_torch.utils import checkpoint as ckpt
from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults
from test_torch_runner import _assert_state_equal, tiny_cv  # noqa: F401

torch.set_num_threads(2)

LR = 0.05
ATOL = 1e-5
DIN, DOUT = 6, 3
UNCOMPRESSED = dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                    error_type="none")
SKETCH = dict(mode="sketch", k=4, num_rows=3, num_cols=8, momentum=0.9,
              momentum_type="virtual", error_type="virtual")
# no organic no-shows or straggle: the wire tests target exactly the
# clients their plan names
RELIABLE = (tclients.DeviceClass("lab", weight=1.0, latency_median_s=0.1, latency_sigma=0.1,
                                 no_show_prob=0.0),)


def _data(num_clients=12):
    rs = np.random.RandomState(0)
    x = rs.randn(96, DIN).astype(np.float32)
    w_true = rs.randn(DIN, DOUT).astype(np.float32)
    y = (x @ w_true).argmax(-1).astype(np.int32)
    w0 = (rs.randn(DIN, DOUT).astype(np.float32) * 0.1)
    return x, y, w0


def _jquad(params, net_state, batch, rng):
    pred = batch["x"] @ params["w"] + params["b"]
    err = pred - jax.nn.one_hot(batch["y"], pred.shape[-1])
    mask = batch["mask"]
    per_ex = (err ** 2).sum(-1)
    return (per_ex * mask).sum() / jnp.maximum(mask.sum(), 1.0), {
        "net_state": net_state,
        "metrics": {"loss_sum": (per_ex * mask).sum(), "count": mask.sum()}}


def _tquad(params, net_state, batch, gen=None):
    pred = batch["x"] @ params["w"] + params["b"]
    # one-hot by comparison: F.one_hot checks its range with .item(), which
    # the engine's torch.func.vmap refuses
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


@pytest.fixture(autouse=True)
def _quad_paths(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", {"w": ("w",), "b": ("b",)}.__getitem__)


def _jsession(mode, fault_plan=None, workers=4, wire=False):
    x, y, w0 = _data()
    train = JFedDataset(x, y, jshard_iid(len(x), 12, np.random.RandomState(1)))
    params = {"w": jnp.asarray(w0), "b": jnp.zeros(DOUT)}
    return JSession(train_loss_fn=_jquad, eval_loss_fn=_jquad, params=params, net_state={},
                    mode_cfg=JModeConfig(d=ravel_pytree(params)[0].size, **mode),
                    train_set=train, num_workers=workers, local_batch_size=4, seed=0,
                    fault_plan=fault_plan, wire_payloads=wire)


def _tsession(mode, fault_plan=None, workers=4, wire=False):
    x, y, w0 = _data()
    train = TFedDataset(x, y, tshard_iid(len(x), 12, np.random.RandomState(1)))
    model = _Quad(w0)
    layout = convert.FlatLayout(model)
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(model.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(d=layout.d, **mode), train_set=train,
                    num_workers=workers, local_batch_size=4, seed=0,
                    fault_plan=TFaultPlan.parse(fault_plan), device="cpu",
                    wire_payloads=wire)


def _serve(session, svc_mod, traffic_mod, n, quorum=2, deadline=1.0, classes=None, **cfg):
    """n served rounds; per round (invites, arrivals, close, requeue, ages,
    the client tables of a payload round)."""
    tables = []
    if session.cfg.wire_payloads:
        compute = session.compute_client_tables

        def recording(prep):
            out = compute(prep)
            tables.append(np.array(out[0]))
            return out

        session.compute_client_tables = recording
    kw = {} if classes is None else {"classes": classes}
    svc = svc_mod.AggregationService(
        session, svc_mod.ServeConfig(quorum=quorum, deadline_s=deadline, **cfg),
        traffic=traffic_mod.TrafficGenerator(
            traffic_mod.TraceConfig(population=session.train_set.num_clients, seed=5), **kw),
    ).start()
    src = svc.source()
    rec = []
    try:
        for _ in range(n):
            prep = src.next()
            c = src.last_closed
            session.commit_round(session.dispatch_round(prep, LR))
            rec.append((c.invited.tolist(), c.arrived.tolist(), c.closed_by,
                        list(session._requeue), dict(session._requeue_enqueued)))
    finally:
        svc.close()
    return rec, tables, svc


def _tparams(s):
    return s.state["params"].numpy()


def _jparams(s):
    return np.asarray(ravel_pytree(jax.device_get(s.state["params"]))[0])


def _drop_plan(rec):
    return ";".join(f"client_drop@{r}:clients=" + "+".join(
        str(p) for p, a in enumerate(arr) if a == 0.0)
        for r, (_, arr, *_rest) in enumerate(rec) if 0.0 in arr)


# ------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("payload", ["announce", "sketch"])
def test_served_rounds_match_jax(payload):
    wire = payload == "sketch"
    mode = SKETCH if wire else UNCOMPRESSED
    kw = dict(payload=payload, deadline=1.0 if not wire else 3.0)
    j = _jsession(mode, wire=wire)
    jrec, jtables, _ = _serve(j, jservice, jtraffic, 3, **kw)
    t = _tsession(mode, wire=wire)
    trec, ttables, _ = _serve(t, tservice, ttraffic, 3, **kw)
    assert trec == jrec  # cohorts, arrivals, closes, requeue and ages
    assert any(0.0 in arr for _, arr, *_ in trec), "no casualties: the pin is vacuous"
    assert len(ttables) == len(jtables) == (3 if wire else 0)
    for tt, jt in zip(ttables, jtables):
        np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_tparams(t), _jparams(j), atol=ATOL)


# ---------------------------------------------------------- within the port


@pytest.mark.parametrize("payload", ["announce", "sketch"])
def test_served_round_bitwise_equals_batch_round_with_drops(payload):
    wire = payload == "sketch"
    mode = SKETCH if wire else UNCOMPRESSED
    plan = ("wire_corrupt@1:clients=0;wire_dup@1:clients=1;"
            "client_poison@2:clients=3,value=nan") if wire else None
    a = _tsession(mode, fault_plan=plan, wire=wire)
    rec, _, svc = _serve(a, tservice, ttraffic, 3, payload=payload,
                         deadline=1.0 if not wire else 30.0,
                         classes=RELIABLE if wire else None)
    drops = _drop_plan(rec)
    assert drops, "no casualties: the pin is vacuous"
    if wire:
        c = svc.queue.counters()
        assert c["rejected_malformed"] >= 1 and c["rejected_dup"] >= 1 \
            and c["rejected_quarantined"] >= 1, c
    b = _tsession(mode, fault_plan=drops, wire=wire)
    for _ in range(3):
        b.run_round(LR)
    _assert_state_equal(a, b)
    assert list(a._requeue) == list(b._requeue)
    assert a._requeue_enqueued == b._requeue_enqueued


def test_full_arrival_round_bitwise_equals_plain_round():
    a = _tsession(UNCOMPRESSED)
    rec, _, _ = _serve(a, tservice, ttraffic, 2, quorum=4, deadline=30.0, classes=RELIABLE)
    assert all(0.0 not in arr for _, arr, *_ in rec)
    b = _tsession(UNCOMPRESSED)
    for _ in range(2):
        b.run_round(LR)
    _assert_state_equal(a, b)


def test_socket_bitwise_equals_inproc_and_eventloop_threaded():
    plan = "wire_corrupt@0:clients=1;wire_truncate@1:clients=2;conn_drop@1:clients=0"
    states = {}
    for name, cfg in (("inproc", {}),
                      ("eventloop", {"transport": "socket", "socket_transport": "eventloop"}),
                      ("threaded", {"transport": "socket", "socket_transport": "threaded"})):
        s = _tsession(SKETCH, fault_plan=plan, wire=True)
        rec, _, svc = _serve(s, tservice, ttraffic, 2, payload="sketch", deadline=30.0,
                             classes=RELIABLE, **cfg)
        states[name] = (s, rec, svc.queue.counters()["rejected_malformed"])
    for name in ("eventloop", "threaded"):
        _assert_state_equal(states["inproc"][0], states[name][0])
        assert states[name][1] == states["inproc"][1]
        # the corrupt and truncated frames, and the dropped connection's
        # partial frame on the socket
        assert states[name][2] >= 2


def test_pending_queue_persists_through_checkpoint(tmp_path):
    a = _tsession(UNCOMPRESSED)
    traffic = ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12, seed=5))
    svc = tservice.AggregationService(a, tservice.ServeConfig(quorum=2, deadline_s=1.0),
                                      traffic=traffic).start()
    try:
        src = svc.source()
        a.commit_round(a.dispatch_round(src.next(), LR))
        svc.queue.open_round(1, [])  # round-2 pushes are now early
        assert svc.queue.submit(Submission(client_id=3, round=2, latency_s=0.4)) == BUFFERED
        svc._record_boundary(1)
        path = ckpt.save(str(tmp_path), a)
    finally:
        svc.close()
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["serve"] == {"round": 1, "pending": [[3, 0.4]]}
    b = _tsession(UNCOMPRESSED)
    ckpt.restore(path, b)
    svc_b = tservice.AggregationService(b, tservice.ServeConfig(quorum=2, deadline_s=1.0),
                                        traffic=traffic)
    try:
        assert svc_b.queue.pending_snapshot() == [(3, 0.4)]
    finally:
        svc_b.close()


def test_metrics_endpoint_over_http():
    a = _tsession(UNCOMPRESSED)
    svc = tservice.AggregationService(
        a, tservice.ServeConfig(quorum=2, deadline_s=1.0, metrics_port=0),
        traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12, seed=5))).start()
    try:
        src = svc.source()
        a.commit_round(a.dispatch_round(src.next(), LR))
        svc.record_merges()
        host, port = svc.metrics_server.address
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5) as resp:
            m = json.loads(resp.read())
        assert m["round"] == 1 and m["rounds"]["rounds_closed"] == 1
        assert m["submissions"]["accepted"] >= 2 and m["latency_ms"]["count"] >= 2
        assert m["serve_stage_ms"]["collect"]["count"] >= 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/other", timeout=5)
    finally:
        svc.close()


# the reference's ServeConfig fields of ROADMAP item 9b, each with a CLI
# value the port does not run
ITEM_9B = {
    "pipeline": ["--serve_pipeline"], "async_mode": ["--serve_async"],
    "buffer_size": ["--serve_buffer", "4"], "staleness_alpha": ["--serve_staleness", "0.9"],
    "stale_rounds": ["--serve_stale_rounds", "3"], "shards": ["--serve_shards", "3"],
    "shard_mode": ["--serve_shard_mode", "process"], "edges": ["--serve_edges", "3"],
    "fastpath": ["--serve_fastpath"], "gauntlet_workers": ["--serve_gauntlet_workers", "3"],
}


@pytest.mark.parametrize("field", list(ITEM_9B))
def test_service_refuses_item_9b_by_name(field):
    """The service has no field for an item-9b option, and the command line
    that asks for one is refused by the flag's name."""
    with pytest.raises(TypeError, match=field):
        tservice.ServeConfig(quorum=2, **{field: 3})
    argv = ITEM_9B[field]
    with pytest.raises(SystemExit, match=f"^{argv[0]} .*item 9b"):
        resolve_defaults(make_parser().parse_args(["--serve", "inproc", *argv]))


def test_stopped_transport_fails_the_round(monkeypatch):
    """A transport failure is an error of the round, not a silent no-show:
    with the socket stopped, or with nothing listening at its address any
    more, the next payload round's submissions raise."""
    s = _tsession(SKETCH, wire=True)
    svc = tservice.AggregationService(
        s, tservice.ServeConfig(quorum=2, deadline_s=30.0, transport="socket",
                                payload="sketch"),
        traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12, seed=5),
                                          classes=RELIABLE)).start()
    try:
        src = svc.source()
        s.commit_round(s.dispatch_round(src.next(), LR))
        svc.transport.stop()
        with pytest.raises(ConnectionError, match="not listening"):
            src.next()
        svc.rewind_to_committed()
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        addr = dead.getsockname()
        dead.close()
        monkeypatch.setattr(type(svc.transport), "address", property(lambda self: addr))
        with pytest.raises(ConnectionRefusedError):
            src.next()
    finally:
        svc.close()


def test_service_refuses_bad_configs():
    a = _tsession(UNCOMPRESSED)
    traffic = ttraffic.TrafficGenerator(ttraffic.TraceConfig())
    with pytest.raises(ValueError, match="quorum"):
        tservice.AggregationService(a, tservice.ServeConfig(quorum=99), traffic=traffic)
    with pytest.raises(ValueError, match="traffic"):
        tservice.AggregationService(a, tservice.ServeConfig(quorum=2))
    with pytest.raises(ValueError, match="wire_payloads"):
        tservice.AggregationService(a, tservice.ServeConfig(payload="sketch"), traffic=traffic)
    with pytest.raises(ValueError, match="mode='sketch'"):
        _tsession(UNCOMPRESSED, wire=True)


# ------------------------------------------------------------------- the CLI


CLI = {
    "announce": ["--mode", "uncompressed", "--serve", "inproc", "--serve_quorum", "3"],
    "sketch": ["--mode", "sketch", "--k", "16", "--num_cols", "256", "--num_rows", "3",
               "--serve", "inproc", "--serve_payload", "sketch", "--serve_quorum", "3"],
}


def _cli(payload, extra=()):
    return ["--dataset", "cifar10", "--num_clients", "8", "--num_workers", "4",
            "--local_batch_size", "4", "--lr_scale", "0.05", "--weight_decay", "0",
            "--data_root", "/nonexistent", "--device", "cpu", "--num_rounds", "4",
            "--serve_deadline", "2.0", "--sync_loop", *CLI[payload], *extra]


@pytest.mark.parametrize("payload", ["announce", "sketch"])
def test_cli_served_preempt_resume_bitwise(tiny_cv, tmp_path, payload):  # noqa: F811
    sa = cv_train.main(_cli(payload))
    chaos = ["--checkpoint_dir", str(tmp_path / "ck"), "--checkpoint_every", "2",
             "--fault_plan", "preempt@2"]
    with pytest.raises(SystemExit) as ei:
        cv_train.main(_cli(payload, chaos))
    assert ei.value.code == EXIT_RESUMABLE
    with open(os.path.join(ckpt.latest(str(tmp_path / "ck")), "meta.json")) as f:
        meta = json.load(f)
    assert meta["serve"] == {"round": 3, "pending": []}
    sc = cv_train.main(_cli(payload, chaos + ["--resume"]))
    assert sc.round == 4
    _assert_state_equal(sa, sc)
    assert list(sa._requeue) == list(sc._requeue)
    assert sa._requeue_enqueued == sc._requeue_enqueued


def test_cli_refuses_item_9b_serve_flags(tiny_cv):  # noqa: F811
    for extra in (["--serve_pipeline"], ["--serve_async"], ["--serve_edges", "2"],
                  ["--serve_fastpath"], ["--serve_shards", "2"]):
        with pytest.raises(SystemExit, match=f"^{extra[0]} .*item 9b"):
            cv_train.main(_cli("announce", extra))
    with pytest.raises(ValueError, match="wire kinds"):
        cv_train.main(_cli("announce", ["--fault_plan", "wire_dup@1:clients=0"]))
