"""The buffered-async service (``--serve_async``, ``--serve_buffer``,
``--serve_staleness``, ``--serve_stale_rounds``) on the CPU: the ingest
queue's stale band, straggler folds through the service, serial and
pipelined, over the socket and in process, and both CLIs.

Against the JAX package (its ravel, single-device path; the quad model of
tests/test_pipeline_serve.py built in both packages with the same
parameters and data):

- the ingest band (tests/test_pipeline_serve.py:209, :387, :410, :428):
  each scenario runs on both queues, and every admission verdict, the
  drained late payloads and the counters are equal;
- async with everyone on time (buffer = cohort): within atol 1e-5 of the
  reference's async run (tests/test_torch_serve.py's tolerance: the
  packages add clients in another float order);
- a buffer of 6 of 8 and a pipelined buffer of 2 of 4: per round the same
  casualties and ``stale_folded``, ``stale_weight`` within rel 1e-6, and
  the params within atol 1e-5.

Within the port, bitwise: async with everyone on time equals the sync
served run (params, optimizer state and every row), pipelined async
equals serial async, and the socket the in-process transport."""

import dataclasses

import numpy as np
import pytest
import torch

import test_pipeline_serve as jpipe
from commefficient_tpu.serve import ingest as jingest
from commefficient_tpu.serve import service as jservice
from commefficient_tpu_torch import cv_train, gpt2_train
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.serve import ingest as tingest
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults
from test_torch_async_robust import _assert_rows_match, _jparams, _tserve
from test_torch_runner import _assert_state_equal, tiny_cv  # noqa: F401
from test_torch_serve import _data, _Quad, _tquad
from test_torch_serve_pipeline import SKETCH16

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture()
def quad(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", {"w": ("w",), "b": ("b",)}.__getitem__)


def _tsession(workers=4, stale_slots=0):
    """The port's twin of tests/test_pipeline_serve.py's payload
    ``_tiny_session``."""
    x, y, w0 = _data()
    train = TFedDataset(x, y, tshard_iid(len(x), 12, np.random.RandomState(1)))
    model = _Quad(w0)
    layout = convert.FlatLayout(model)
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(model.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(d=layout.d, **SKETCH16), train_set=train,
                    num_workers=workers, local_batch_size=4, seed=0, device="cpu",
                    wire_payloads=True, stale_slots=stale_slots)


def _cfg(**kw):
    return tservice.ServeConfig(payload="sketch", **kw)


# ------------------------------------------------------------ the ingest band


def _queues(**kw):
    """The same queue in both packages; ``policy`` a PayloadPolicy's kwargs,
    its median a function of the call count."""
    policy = kw.pop("policy", None)
    out = []
    for mod in (jingest, tingest):
        p = None
        if policy is not None:
            medians = iter(policy.get("medians", [1000.0] * 8))
            p = mod.PayloadPolicy(rows=1, cols=4, clip_multiple=policy.get("clip", 0.0),
                                  quarantine_median=lambda m=medians: next(m))
        out.append(mod.IngestQueue(payload_policy=p, **kw))
    return out


def _both(queues, op, *args):
    """``op`` on both queues: the results, asserted equal."""
    got = []
    for q, mod in zip(queues, (jingest, tingest)):
        a = [mod.Submission(client_id=x[0], round=x[1], latency_s=0.1, payload=x[2])
             if isinstance(x, tuple) else x for x in args]
        got.append(getattr(q, op)(*a))
    assert got[0] == got[1], (op, args, got)
    return got[1]


T = np.ones((1, 4), np.float32)


def test_stale_band_admits_late_payload_against_its_rounds_state():
    qs = _queues(capacity=8, policy={"clip": 2.0}, stale_rounds=1, stale_capacity=4)
    _both(qs, "open_round", 0, [1, 2, 3])
    assert _both(qs, "submit", (1, 0, T)) == tingest.ACCEPTED
    [q.close_round(0) for q in qs]
    _both(qs, "open_round", 1, [4])
    # late for round 0, inside the one-round band
    assert _both(qs, "submit", (2, 0, T)) == tingest.ACCEPTED_STALE
    assert _both(qs, "submit", (2, 0, T)) == tingest.DUPLICATE
    assert _both(qs, "submit", (1, 0, T)) == tingest.DUPLICATE
    assert _both(qs, "submit", (9, 0, T)) == tingest.NOT_INVITED
    drained = [[(a.round, a.client_id, a.recv_order) for a in q.drain_stale()] for q in qs]
    assert drained[0] == drained[1] == [(0, 2, 1)]
    assert qs[0].counters() == qs[1].counters() and qs[1].counters()["accepted_stale"] == 1
    # the band moves with the newest window: round 0 ages out at open(2)
    [q.close_round(1) for q in qs]
    _both(qs, "open_round", 2, [5])
    assert _both(qs, "submit", (3, 0, T)) == tingest.OUT_OF_ROUND


def test_late_payload_is_screened_against_its_own_rounds_median():
    """Round 0 opened at median 1 and round 1 at 100: a late table of L2
    100 is QUARANTINED against round 0's median, not round 1's."""
    qs = _queues(capacity=8, policy={"clip": 2.0, "medians": [1.0, 100.0]}, stale_rounds=1,
                 stale_capacity=4)
    _both(qs, "open_round", 0, [1, 2])
    [q.close_round(0) for q in qs]
    _both(qs, "open_round", 1, [3])
    big = np.full((1, 4), 50.0, np.float32)
    assert _both(qs, "submit", (1, 0, big)) == tingest.QUARANTINED
    assert _both(qs, "submit", (3, 1, big)) == tingest.ACCEPTED


def test_rewind_prunes_uncommitted_stale_entries_from_queue():
    qs = _queues(capacity=8, policy={"clip": 2.0}, stale_rounds=2, stale_capacity=4)
    _both(qs, "open_round", 5, [1, 2])
    [q.close_round(5) for q in qs]
    _both(qs, "open_round", 6, [3])
    assert _both(qs, "submit", (1, 5, T)) == tingest.ACCEPTED_STALE
    assert _both(qs, "prune_stale", 5) == 1
    assert [q.drain_stale() for q in qs] == [[], []]
    assert _both(qs, "submit", (2, 5, T)) == tingest.OUT_OF_ROUND


def test_prune_stale_rewinds_early_push_high_water_mark():
    qs = _queues(capacity=8)
    _both(qs, "open_round", 0, [1])
    _both(qs, "open_round", 1, [2])
    [q.close_round(r) for q in qs for r in (0, 1)]
    _both(qs, "prune_stale", 1)
    _both(qs, "open_round", 1, [2])
    assert _both(qs, "submit", (5, 2, None)) == tingest.BUFFERED


def test_shed_retry_of_stale_admitted_submission_hears_duplicate():
    qs = _queues(capacity=4, pending_capacity=0, policy={}, stale_rounds=1, stale_capacity=4,
                 shed_watermark=0.25)
    _both(qs, "open_round", 0, [1, 2, 3])
    [q.close_round(0) for q in qs]
    _both(qs, "open_round", 1, [4, 5, 6])
    assert _both(qs, "submit", (1, 0, T)) == tingest.ACCEPTED_STALE
    assert _both(qs, "submit", (4, 1, T)) == tingest.ACCEPTED
    _both(qs, "submit", (5, 1, T))
    assert qs[1].depth() >= qs[1]._shed_depth
    assert _both(qs, "submit", (1, 0, T)) == tingest.DUPLICATE


def test_band_snapshot_and_restore_round_trip():
    q = _queues(capacity=8, policy={}, stale_rounds=1, stale_capacity=4)[1]
    q.open_round(0, [1, 2])
    q.close_round(0)
    q.open_round(1, [3])
    assert q.submit(tingest.Submission(2, 0, 0.1, payload=T)) == tingest.ACCEPTED_STALE
    pending, band = q.boundary_snapshot()
    r = _queues(capacity=8, policy={}, stale_rounds=1, stale_capacity=4)[1]
    r.restore_band(band)
    assert r.band_snapshot() == band
    assert r.submit(tingest.Submission(2, 0, 0.1, payload=T)) == tingest.DUPLICATE
    assert r.submit(tingest.Submission(1, 0, 0.1, payload=T)) == tingest.ACCEPTED_STALE


# ---------------------------------------------------------- the async service


def test_async_everyone_on_time_bitwise_equals_sync_and_matches_reference(quad):
    a = _tsession()
    ra = _tserve(a, _cfg(quorum=4, deadline_s=1e9), 4)
    b = _tsession(stale_slots=4)
    rb = _tserve(b, _cfg(quorum=4, deadline_s=1e9, async_mode=True, buffer_size=4), 4)
    assert ra == rb and not any("stale_folded" in r for r in rb)
    _assert_state_equal(a, b)
    j = jpipe._tiny_session(payload=True, stale_slots=4)
    jrows = jpipe._serve(j, jservice.ServeConfig(quorum=4, deadline_s=1e9, payload="sketch",
                                                 async_mode=True, buffer_size=4), 4)
    _assert_rows_match(rb, jrows)
    np.testing.assert_allclose(b.state["params"].numpy(), _jparams(j), atol=ATOL)


@pytest.mark.parametrize("pipelined", [False, True])
def test_buffer_six_of_eight_folds_stragglers_as_the_reference(quad, pipelined):
    cfg = dict(quorum=8, deadline_s=60.0, payload="sketch", async_mode=True, buffer_size=6,
               pipeline=pipelined)
    j = jpipe._tiny_session(payload=True, stale_slots=8, workers=8)
    jrows = jpipe._serve(j, jservice.ServeConfig(**cfg), 5)
    t = _tsession(workers=8, stale_slots=8)
    trows = _tserve(t, tservice.ServeConfig(**cfg), 5)
    _assert_rows_match(trows, jrows)
    folded = [r for r in trows[1:] if r.get("stale_folded", 0) > 0]
    assert folded and "stale_folded" not in trows[0], trows
    assert all(0 < r["stale_weight"] < r["stale_folded"] for r in folded)
    np.testing.assert_allclose(t.state["params"].numpy(), _jparams(j), atol=ATOL)
    # a folded straggler was masked and queued at its own close: the same
    # ids, in the same order, with the same ages
    assert list(t._requeue) == [int(c) for c in j._requeue]
    assert t._requeue_enqueued == {int(c): int(r) for c, r in j._requeue_enqueued.items()}


def test_pipelined_async_bitwise_equals_serial_async(quad):
    cfg = _cfg(quorum=4, deadline_s=60.0, async_mode=True, buffer_size=2)
    a = _tsession(stale_slots=4)
    ra = _tserve(a, cfg, 5)
    b = _tsession(stale_slots=4)
    rb = _tserve(b, dataclasses.replace(cfg, pipeline=True), 5)
    assert ra == rb and any(r.get("stale_folded", 0) for r in ra)
    _assert_state_equal(a, b)
    assert list(a._requeue) == list(b._requeue) and a._requeue_enqueued == b._requeue_enqueued


def test_socket_async_bitwise_equals_inproc_async(quad):
    cfg = _cfg(quorum=4, deadline_s=60.0, async_mode=True, buffer_size=2)
    a = _tsession(stale_slots=4)
    ra = _tserve(a, cfg, 4)
    b = _tsession(stale_slots=4)
    rb = _tserve(b, dataclasses.replace(cfg, transport="socket"), 4)
    assert ra == rb and any(r.get("stale_folded", 0) for r in ra)
    _assert_state_equal(a, b)


def test_stale_band_expiry_drops_and_counts(quad):
    mark = obreg.default().mark()
    s = _tsession(stale_slots=4)
    svc = tservice.AggregationService(
        s, _cfg(quorum=4, deadline_s=60.0, async_mode=True, buffer_size=2, stale_rounds=1),
        traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12,
                                                               seed=5))).start()
    try:
        src = svc.source()
        prep = src.next()
        assert svc._stale_stash
        # the stash aged past the band: the next fold drops it, counted
        svc._stale_stash = [(e[0] - 5,) + e[1:] for e in svc._stale_stash]
        s.commit_round(s.dispatch_round(prep, 0.05))
        src.on_dispatched(s.round - 1)
        src.next()
        src.stop()
        snap = svc.metrics_snapshot()
    finally:
        svc.close()
    assert mark.delta("serve_stale_dropped_total") >= 1
    assert snap["async"] and snap["stale"]["dropped"] >= 1 and snap["stale"]["buffer_size"] == 2
    assert snap["rounds"]["closed_by_quorum"] >= 1  # the buffer trigger's closes


def test_async_config_validation(quad):
    traffic = ttraffic.TrafficGenerator(ttraffic.TraceConfig())
    sync = _tsession()
    with pytest.raises(ValueError, match="announce"):
        tservice.AggregationService(sync, tservice.ServeConfig(quorum=2, async_mode=True),
                                    traffic=traffic)
    with pytest.raises(ValueError, match="stale_slots"):
        tservice.AggregationService(sync, _cfg(quorum=2, async_mode=True), traffic=traffic)
    with pytest.raises(ValueError, match="serve_buffer"):
        tservice.AggregationService(sync, tservice.ServeConfig(quorum=2, buffer_size=3),
                                    traffic=traffic)
    s = _tsession(stale_slots=4)
    with pytest.raises(ValueError, match="serve_stale_rounds"):
        tservice.AggregationService(s, _cfg(async_mode=True, stale_rounds=0), traffic=traffic)
    with pytest.raises(ValueError, match="serve_staleness"):
        tservice.AggregationService(s, _cfg(async_mode=True, staleness_alpha=-1.0),
                                    traffic=traffic)
    svc = tservice.AggregationService(s, _cfg(quorum=3, async_mode=True), traffic=traffic)
    assert svc.cfg.buffer_size == 3 and svc.assembler.trigger_label == "buffer"
    svc.close()


# ----------------------------------------------------------------------- CLIs


@pytest.mark.parametrize("task", ["cv", "gpt2"])
def test_cli_flags_parse_with_the_reference_launch_errors(task):
    base = ["--mode", "sketch", "--k", "4"]

    def parse(extra):
        return resolve_defaults(make_parser(task).parse_args(base + extra))

    with pytest.raises(SystemExit, match="arm --serve inproc"):
        parse(["--serve_async"])
    with pytest.raises(SystemExit, match="serve_payload sketch"):
        parse(["--serve", "inproc", "--serve_async"])
    with pytest.raises(SystemExit, match="serve_async"):
        parse(["--serve", "inproc", "--serve_buffer", "3"])
    args = parse(["--serve", "socket", "--serve_payload", "sketch", "--serve_async",
                  "--serve_buffer", "3", "--serve_staleness", "0.25",
                  "--serve_stale_rounds", "2"])
    cfg = tservice.ServeConfig.from_args(args)
    assert (cfg.async_mode, cfg.buffer_size, cfg.staleness_alpha, cfg.stale_rounds) == \
        (True, 3, 0.25, 2)


CV_CLI = ["--dataset", "cifar10", "--mode", "sketch", "--k", "100", "--num_cols", "2000",
          "--num_rows", "3", "--num_clients", "8", "--num_workers", "4",
          "--local_batch_size", "4", "--lr_scale", "0.05", "--weight_decay", "0",
          "--data_root", "/nonexistent", "--device", "cpu", "--num_rounds", "3",
          "--eval_every", "3", "--sync_loop", "--serve", "inproc", "--serve_payload",
          "sketch", "--serve_deadline", "30"]


def test_cv_cli_async_on_time_bitwise_sync_and_stale_poison_context(tiny_cv, capsys):  # noqa: F811
    sync = cv_train.main(CV_CLI)
    async_ = cv_train.main(CV_CLI + ["--serve_async", "--serve_buffer", "4"])
    _assert_state_equal(sync, async_)
    assert async_.cfg.stale_slots == 4 and sync.cfg.stale_slots == 0
    out = capsys.readouterr().out
    assert "async (alpha=0.5, band=1), buffer 4/4" in out and "'async': True" in out
    with pytest.raises(ValueError, match="stale band"):
        cv_train.main(CV_CLI + ["--fault_plan", "client_stale_poison@1:clients=0"])
    poisoned = cv_train.main(CV_CLI + ["--serve_async", "--serve_buffer", "4", "--fault_plan",
                                       "client_stale_poison@1:clients=0"])
    assert torch.isfinite(poisoned.state["params"]).all()
    assert not torch.equal(poisoned.state["params"], sync.state["params"])


GPT2_CLI = ["--model_size", "tiny", "--seq_len", "16", "--num_clients", "8",
            "--num_workers", "4", "--local_batch_size", "2", "--num_rounds", "2",
            "--eval_every", "2", "--eval_batch_size", "8", "--data_root", "/nonexistent",
            "--device", "cpu", "--mode", "sketch", "--k", "100", "--num_cols", "2000",
            "--serve", "inproc", "--serve_payload", "sketch", "--serve_deadline", "30",
            "--serve_async", "--serve_buffer", "3", "--serve_staleness", "0.25"]


def test_gpt2_cli_runs_the_async_service(capsys, monkeypatch):
    folds = []
    fold = tengine._stale_fold
    monkeypatch.setattr(tengine, "_stale_fold", lambda *a: folds.append(1) or fold(*a))
    s = gpt2_train.main(GPT2_CLI)
    assert s.round == 2 and s.cfg.stale_slots == 4 and torch.isfinite(s.state["params"]).all()
    out = capsys.readouterr().out
    assert "async (alpha=0.25, band=1), buffer 3/4" in out, out
    assert folds == [1]  # round 0's straggler folds into round 1
