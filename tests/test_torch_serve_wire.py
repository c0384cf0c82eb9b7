"""The port's serving wire, held exactly against the JAX package's on the
same numpy inputs: payload frames (byte for byte, unchunked and chunked),
the validation verdicts (decision and detail), the ingest queue's
admission decisions and counters, the splitmix64 client streams, device
classes, response latencies, arrival events and the retry jitter, the
wire fault plan and its frame damage, and one rotation sketch of the same
update. Everything here is host work, so every comparison is exact."""

import base64
import json

import numpy as np
import pytest
import torch

from commefficient_tpu.resilience.faults import FaultPlan as JFaultPlan
from commefficient_tpu.serve import clients as jclients
from commefficient_tpu.serve import ingest as jingest
from commefficient_tpu.serve import traffic as jtraffic
from commefficient_tpu.serve import transport as jtransport
from commefficient_tpu.sketch import csvec as jcsvec
from commefficient_tpu.sketch import payload as jpayload
from commefficient_tpu_torch.resilience.faults import FaultPlan as TFaultPlan
from commefficient_tpu_torch.serve import clients as tclients
from commefficient_tpu_torch.serve import ingest as tingest
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.serve import transport as ttransport
from commefficient_tpu_torch.sketch import csvec as tcsvec
from commefficient_tpu_torch.sketch import payload as tpayload

SHAPE = (3, 500)  # (rows, cols): 6,000 bytes, chunked below that


def _table(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- frames


@pytest.mark.parametrize("cap", [0, 1024, 2048, 4000, 100_000])
def test_encode_frame_byte_equal(cap):
    t = _table()
    got = tpayload.encode_frame(t, max_frame_bytes=cap)
    want = jpayload.encode_frame(t, max_frame_bytes=cap)
    assert json.dumps(got) == json.dumps(want)
    if cap and cap < 6000:
        assert isinstance(got, list) and len(got) > 1  # the chunked path ran
    assert (tpayload.SCHEMA_VERSION, tpayload.WIRE_DTYPE, tpayload.MAX_CHUNKS) == \
        (jpayload.SCHEMA_VERSION, jpayload.WIRE_DTYPE, jpayload.MAX_CHUNKS)
    for c in (600, 1024, 5000, 1 << 20):
        assert tpayload._chunk_raw_budget(c) == jpayload._chunk_raw_budget(c)


@pytest.mark.parametrize("cap", [0, 1024, 2048, 4000, 100_000])
def test_chunk_frame_equals_encode_frame(cap):
    """A built frame chunked at a cap is byte-equal to the table encoded at
    that cap, so a damaged frame crosses a socket as a clean one would."""
    t = _table()
    got = tpayload.chunk_frame(tpayload.encode_frame(t), cap)
    assert json.dumps(got) == json.dumps(jpayload.encode_frame(t, max_frame_bytes=cap))


@pytest.mark.parametrize("engine", ["eventloop", "threaded"])
def test_damaged_frame_over_cap_reaches_validation(engine, capfd):
    """A corrupt or truncated frame bigger than the socket's frame cap is
    chunked by the client and rejected MALFORMED by the validation, as the
    in-process transport rejects it, instead of being cut off at the cap."""
    from commefficient_tpu_torch.serve.scale.eventloop import EventLoopTransport

    cap = 4096  # three chunks of the 6,000-byte table
    q = tingest.IngestQueue(payload_policy=tingest.PayloadPolicy(*SHAPE))
    q.open_round(0, [7, 8, 9])
    cls = EventLoopTransport if engine == "eventloop" else ttransport.SocketTransport
    tr = cls(q, max_frame_bytes=cap)
    tr.start()
    try:
        frame = tpayload.encode_frame(_table())
        subs = {7: TFaultPlan.corrupt_frame(frame), 8: TFaultPlan.truncate_frame(frame),
                9: _table()}
        got = {c: ttransport.submit_over_socket(tr.address, tingest.Submission(
            client_id=c, round=0, latency_s=0.1, payload=p), max_frame_bytes=cap)
            for c, p in subs.items()}
    finally:
        tr.stop()
    assert got == {7: tingest.MALFORMED, 8: tingest.MALFORMED, 9: tingest.ACCEPTED}
    assert q.counters()["rejected_malformed"] == 2
    # the validation's verdicts, not the frame cap's
    err = capfd.readouterr().err
    assert "client 7 rejected MALFORMED (checksum mismatch)" in err, err
    assert "client 8 rejected MALFORMED (decoded 3000 bytes" in err, err


# ------------------------------------------------------ validation verdicts


def _frame(t=None, **over):
    f = jpayload.encode_frame(_table() if t is None else t)
    f.update(over)
    return f


def _chunks(cap=2048):
    return jpayload.encode_frame(_table(), max_frame_bytes=cap)


def _flip(f):
    raw = bytearray(base64.b64decode(f["data"]))
    raw[7] ^= 0x01
    return {**f, "data": base64.b64encode(bytes(raw)).decode()}


PAYLOADS = {
    "clean_frame": lambda: _frame(),
    "clean_array": lambda: _table(),
    "flipped_checksum": lambda: _flip(_frame()),
    "truncated": lambda: jpayload.encode_frame(_table()) | {
        "data": jpayload.encode_frame(_table())["data"][:400]},
    "stale_schema": lambda: _frame(schema=1),
    "bad_shape_frame": lambda: _frame(shape=[3, 499]),
    "bad_shape_array": lambda: _table(shape=(3, 499)),
    "bad_dtype_frame": lambda: _frame(dtype="<f8"),
    "bad_dtype_array": lambda: _table().astype(np.float64),
    "bad_length_prefix": lambda: _frame(nbytes=12),
    "garbage_string": lambda: "garbage",
    "garbage_base64": lambda: _frame(data="not base64!!"),
    "missing_schema": lambda: {k: v for k, v in _frame().items() if k != "schema"},
    "none": lambda: None,
    "nan_table": lambda: _frame(np.where(_table() > 1, np.nan, _table()).astype(np.float32)),
    "inf_array": lambda: np.where(_table() > 1, np.inf, _table()).astype(np.float32),
    "chunks_in_order": lambda: _chunks(),
    "chunks_reordered": lambda: [_chunks()[1], _chunks()[0]] + _chunks()[2:],
    "chunks_duplicated": lambda: _chunks()[:2] + _chunks()[1:],
    "chunks_partial": lambda: _chunks()[:-1],
    "chunk_alone": lambda: _chunks()[1],
    "chunks_mixed_schema": lambda: _chunks()[:1] + [dict(_chunks()[1], schema=1)]
    + _chunks()[2:],
}


@pytest.mark.parametrize("case", list(PAYLOADS))
def test_validate_payload_verdicts_equal(case):
    t_table, t_dec, t_detail = tingest.validate_payload(
        PAYLOADS[case](), tingest.PayloadPolicy(rows=SHAPE[0], cols=SHAPE[1]))
    j_table, j_dec, j_detail = jingest.validate_payload(
        PAYLOADS[case](), jingest.PayloadPolicy(rows=SHAPE[0], cols=SHAPE[1]))
    assert (t_dec, t_detail) == (j_dec, j_detail)
    if j_table is None:
        assert t_table is None
    else:
        assert t_table.dtype == np.float32
        np.testing.assert_array_equal(t_table, j_table)
    if case.startswith("clean") or case == "chunks_in_order":
        assert t_dec == tingest.ACCEPTED


# ------------------------------------------------------- admission decisions


def _scenario(mod, name):
    """One scripted sequence of queue operations; returns every decision
    and the final counters."""
    Sub = mod.Submission
    out = []
    if name == "announce":
        q = mod.IngestQueue()
        q.open_round(0, [3, 5, 7])
        out += [q.submit(Sub(c, r, latency_s=0.1 * c)) for c, r in
                ((3, 0), (3, 0), (9, 0), (5, 1), (5, 1), (6, 1), (7, 2), (5, -1))]
        out.append([(a.client_id, a.latency_s, a.recv_order) for a in q.close_round(0)])
        q.open_round(1, [5, 8])
        out.append([(a.client_id, a.latency_s) for a in q.arrivals(1)])
        out.append(q.pending_snapshot())
        out.append(q.submit(Sub(3, 0)))
    elif name == "capacity":
        q = mod.IngestQueue(capacity=2, pending_capacity=1)
        q.open_round(4, list(range(10)))
        out += [q.submit(Sub(c, 4)) for c in (0, 1, 2, 2)]
        out += [q.submit(Sub(c, 5)) for c in (7, 7, 8)]
        q.shutdown()
        out.append(q.submit(Sub(3, 4)))
    elif name == "shedding":
        q = mod.IngestQueue(capacity=4, pending_capacity=4, shed_watermark=0.5,
                            shed_retry_after_s=2.5)
        q.open_round(0, list(range(10)))
        out += [q.submit(Sub(c, 0)) for c in (0, 1, 2, 3, 4, 0, 1)]
        out.append(q.shed_retry_after_s)
    elif name == "payload":
        q = mod.IngestQueue(payload_policy=mod.PayloadPolicy(rows=SHAPE[0], cols=SHAPE[1]))
        q.open_round(2, [1, 2, 3, 4])
        out += [q.submit(Sub(1, 2, payload=_table())),
                q.submit(Sub(1, 2, payload=_table())),
                q.submit(Sub(2, 2, payload=_flip(_frame()))),
                q.submit(Sub(3, 2, payload=_frame(schema=9))),
                q.submit(Sub(4, 2, payload=np.full(SHAPE, np.nan, np.float32))),
                q.submit(Sub(4, 2, payload=_chunks())),
                q.submit(Sub(2, 3, payload=_table()))]
        arr = q.close_round(2)
        out.append([(a.client_id, float(a.table.sum())) for a in arr])
        q.note_wire_malformed()
    counters = q.counters()
    out.append({k: v for k, v in counters.items() if k != "accepted_stale"})
    return out


@pytest.mark.parametrize("name", ["announce", "capacity", "shedding", "payload"])
def test_ingest_queue_decisions_equal(name):
    assert _scenario(tingest, name) == _scenario(jingest, name)


def test_shed_reply_carries_the_retry_after_hint_in_both():
    replies = []
    for mod, tr in ((tingest, ttransport), (jingest, jtransport)):
        q = mod.IngestQueue(shed_retry_after_s=0.75)
        replies.append(tr.SocketTransport(q)._reply_for(mod.SHEDDING))
    assert replies[0] == replies[1] == {"status": "SHEDDING", "retry_after_s": 0.75}


# ------------------------------------------------------------- client streams


def test_client_streams_and_latencies_equal():
    ids = np.arange(0, 50_000, 7, dtype=np.int64)
    for seed in (0, 42, 2**40 + 3):
        np.testing.assert_array_equal(tclients.fold_in_host(seed, ids, 5, 9),
                                      jclients.fold_in_host(seed, ids, 5, 9))
        np.testing.assert_array_equal(tclients.uniform01(seed, ids, 3),
                                      jclients.uniform01(seed, ids, 3))
        np.testing.assert_array_equal(tclients.device_class_index(seed, ids),
                                      jclients.device_class_index(seed, ids))
        for rnd in (0, 1, 17):
            np.testing.assert_array_equal(tclients.response_latency_s(seed, ids, rnd),
                                          jclients.response_latency_s(seed, ids, rnd))
    p = np.linspace(1e-9, 1 - 1e-9, 1001)
    np.testing.assert_array_equal(tclients._norm_ppf(p), jclients._norm_ppf(p))
    assert [c.name for c in tclients.DEFAULT_CLASSES] == [c.name for c in
                                                          jclients.DEFAULT_CLASSES]


def test_trace_parse_and_arrival_events_equal():
    spec = "population=5000,base_rate=40,burst_rate=0.5,burst_size=9,seed=11"
    tc, jc = ttraffic.TraceConfig.parse(spec), jtraffic.TraceConfig.parse(spec)
    assert tc == ttraffic.TraceConfig(**vars(jc))
    for mod in (ttraffic, jtraffic):
        with pytest.raises(ValueError, match="unknown key"):
            mod.TraceConfig.parse("populace=3")
    tg, jg = ttraffic.TrafficGenerator(tc), jtraffic.TrafficGenerator(jc)
    got = list(tg.arrival_events(100.0, 8.0, window_s=0.5))
    want = list(jg.arrival_events(100.0, 8.0, window_s=0.5))
    assert len(got) == len(want) > 0
    for (ta, ia), (tb, ib) in zip(got, want):
        assert ta == tb
        np.testing.assert_array_equal(ia, ib)
    assert [tg.rate_at(t) for t in (0, 1e4, 5e4)] == [jg.rate_at(t) for t in (0, 1e4, 5e4)]


def test_respond_to_invites_submissions_equal():
    """The same invites, payloads and wire plan push the same submissions
    in the same order, with the same frame damage, in both packages."""
    ids = np.array([11, 4, 29, 7, 42, 0, 18, 33])
    tables = [_table(i) for i in range(len(ids))]
    plan = "wire_corrupt@3:clients=0;wire_truncate@3:clients=2;wire_dup@3:clients=1;" \
           "wire_delay@3:clients=4,secs=0.5;conn_drop@3:clients=5"
    subs = {}
    for name, tmod, pmod in (("torch", ttraffic, TFaultPlan), ("jax", jtraffic, JFaultPlan)):
        got, aborted = [], []
        gen = tmod.TrafficGenerator(tmod.TraceConfig(population=50, seed=9))
        wire = pmod.parse(plan).wire_plan(3, len(ids))
        n = gen.respond_to_invites(3, ids, got.append, 6.0, payloads=tables, wire=wire,
                                   abort=aborted.append)
        subs[name] = (n, [(s.client_id, s.round, s.latency_s,
                           json.dumps(s.payload) if isinstance(s.payload, dict)
                           else s.payload.tobytes()) for s in got + aborted])
    assert subs["torch"] == subs["jax"]
    assert len(subs["torch"][1]) > 0


def test_submit_with_retries_schedules_equal(monkeypatch):
    """The jittered backoff is a pure function of (client, round, attempt):
    the same schedule in both packages, for transport failures and for
    SHEDDING with its retry-after floor."""
    schedules = {}
    for name, mod in (("torch", ttransport), ("jax", jtransport)):
        for why in ("refused", "shedding"):
            def fake(addr, sub, timeout_s=5.0, _why=why):
                if _why == "refused":
                    raise ConnectionRefusedError("down")
                return {"status": "SHEDDING", "retry_after_s": 0.07}

            monkeypatch.setattr(mod, "_roundtrip", fake)
            sleeps = []
            status = mod.submit_with_retries(
                ("h", 1), mod.Submission(client_id=7, round=3), max_retries=4,
                base_backoff_s=0.01, max_backoff_s=0.3, sleep=sleeps.append)
            schedules[(name, why)] = (status, sleeps)
    assert schedules[("torch", "refused")] == schedules[("jax", "refused")]
    assert schedules[("torch", "shedding")] == schedules[("jax", "shedding")]
    assert schedules[("torch", "refused")][0] == "CONN_FAILED"
    assert len(schedules[("torch", "refused")][1]) == 4


# ------------------------------------------------------------------ fault plan


WIRE_PLAN = ("wire_corrupt@1:clients=0+2;wire_truncate@1,2:clients=3;wire_dup@2:clients=1;"
             "wire_delay@1:clients=0,secs=0.25;wire_delay@1:clients=0,secs=0.5;"
             "conn_drop@2:clients=4;client_drop@1:clients=5")


def test_wire_plan_equal():
    tp, jp = TFaultPlan.parse(WIRE_PLAN), JFaultPlan.parse(WIRE_PLAN)
    assert [(s.kind, s.rounds, s.params) for s in tp.specs] == \
        [(s.kind, s.rounds, s.params) for s in jp.specs]
    for rnd in (0, 1, 2, 1, 2, 3):  # the second visit finds every site fired
        assert tp.wire_plan(rnd, 6) == jp.wire_plan(rnd, 6)
    frame = jpayload.encode_frame(_table())
    assert TFaultPlan.corrupt_frame(frame) == JFaultPlan.corrupt_frame(frame)
    assert TFaultPlan.truncate_frame(frame) == JFaultPlan.truncate_frame(frame)
    for plan in (tp, jp):
        with pytest.raises(ValueError, match="can never fire"):
            plan.validate_rounds(2)
        with pytest.raises(ValueError, match="can never fire"):
            plan.validate_wire_context(False)
        plan.validate_wire_context(True)
    with pytest.raises(ValueError, match="out of range"):
        TFaultPlan.parse("wire_dup@0:clients=9").wire_plan(0, 4)


# ---------------------------------------------------------------- the sketch


def test_rotation_sketch_and_client_table_bitwise():
    """The port's sketch of one update (what its client step ships) is
    bitwise the JAX package's ``client_table`` of it."""
    from commefficient_tpu.sketch.csvec import CSVecSpec as JSpec

    d, c, r = 20_011, 1_000, 5
    v = np.random.RandomState(3).standard_normal(d).astype(np.float32)
    tspec = tcsvec.CSVecSpec(d=d, c=c, r=r, seed=42, family="rotation")
    jspec = JSpec(d=d, c=c, r=r, seed=42, family="rotation")
    got = tcsvec.sketch_vec(tspec, torch.from_numpy(v)).numpy()
    want = jpayload.client_table(jspec, v)
    assert got.dtype == np.float32 and got.shape == (r, c)
    np.testing.assert_array_equal(got, want)
    # the framed table decodes to the same bytes in both validations
    frame = tpayload.encode_frame(got, max_frame_bytes=8192)
    policy = (r, c)
    t, dec, _ = tingest.validate_payload(frame, tingest.PayloadPolicy(*policy))
    j, jdec, _ = jingest.validate_payload(frame, jingest.PayloadPolicy(*policy))
    assert dec == jdec == tingest.ACCEPTED
    np.testing.assert_array_equal(t, want)
    np.testing.assert_array_equal(j, want)
