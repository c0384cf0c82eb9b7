"""The serving fast path (``--serve_fastpath``, ``--serve_gauntlet_workers``)
on the CPU: the table ring (``serve/ring.py``), the batched validation
(``serve/gauntlet.py``, ``IngestQueue.submit_block``, ``screen_block``) and
the service's ring-built stack (``serve/service.py``).

Against the JAX package, on tests/test_serve.py's tiny payload session
(3 x 8 tables, 4 of 12 clients) built in both packages with the same
parameters and data:

- a ``RingBlock`` and a ``TableRing`` after the same acquire, write,
  commit, reject, overflow and extra sequence: the same tables, positions,
  validity, finalized prefixes, snapshots and overflow counts;
- ``GauntletPool``: the same verdict for every submission, through both
  entries, and CLOSED for everyone after ``stop``;
- ``screen_block``: the reference's verdicts and detail strings;
- a damaged frame of every kind of tests/test_serve.py's ``DAMAGE`` inside
  a ``submit_block`` (ring slots attached): the reference's statuses and
  counters, and the port's batched round bitwise its scalar round;
- a fast-path served run against the reference's fast-path run on the same
  trace: the same casualties and counters, the params within atol 1e-5
  (the one-device served runs' tolerance: the packages add clients in
  another float order);
- the ``fastpath`` block of ``metrics_snapshot`` has the reference's keys.

Within the port, bitwise: fastpath on equals fastpath off under
``wire_corrupt@1:clients=0;client_poison@2:clients=3,value=nan`` with the
clip at 3, in process, over the socket with both engines, async with a
buffer of 6 of 8 and pipelined; the chaos went through the batched
validation (its counters move), and over the socket the fast run copies
fewer table bytes than the slow one."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import test_serve as jserve
from commefficient_tpu.serve import gauntlet as jgauntlet
from commefficient_tpu.serve import ingest as jingest
from commefficient_tpu.serve import ring as jring
from commefficient_tpu.sketch import payload as jpayload
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.federated.api import FedOptimizer
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.resilience import FaultPlan as TFaultPlan
from commefficient_tpu_torch.runner.loop import RunnerConfig, run_loop
from commefficient_tpu_torch.serve import assembler as tassembler
from commefficient_tpu_torch.serve import gauntlet as tgauntlet
from commefficient_tpu_torch.serve import ingest as tingest
from commefficient_tpu_torch.serve import metrics as tmetrics
from commefficient_tpu_torch.serve import ring as tring
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.sketch import payload as tpayload
from test_torch_runner import _assert_state_equal
from test_torch_serve import RELIABLE, SKETCH, _data, _Quad, _tquad

torch.set_num_threads(2)

LR = 0.05
ATOL = 1e-5
SHAPE = (3, 8)
PLAN = "wire_corrupt@1:clients=0;client_poison@2:clients=3,value=nan"


@pytest.fixture(autouse=True)
def _quad_paths(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", {"w": ("w",), "b": ("b",)}.__getitem__)


def _tsession(fault_plan=None, clip=0.0, workers=4, stale_slots=0, shards=0):
    """The port's twin of tests/test_serve.py's ``_sketch_session``."""
    x, y, w0 = _data()
    train = TFedDataset(x, y, tshard_iid(len(x), 12, np.random.RandomState(1)))
    model = _Quad(w0)
    layout = convert.FlatLayout(model)
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(model.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(d=layout.d, **SKETCH), train_set=train,
                    num_workers=workers, local_batch_size=4, seed=0,
                    fault_plan=TFaultPlan.parse(fault_plan), device="cpu", wire_payloads=True,
                    client_update_clip=clip, stale_slots=stale_slots, client_shards=shards)


def _table(fill=0.5, seed=None):
    if seed is not None:
        return np.random.RandomState(seed).standard_normal(SHAPE).astype(np.float32)
    return np.full(SHAPE, fill, np.float32)


# ------------------------------------------------------------- the ring


def _ring_state(blk):
    return (blk.tables.copy(), blk.positions.copy(), blk.valid.copy(), blk.count,
            [(p, t.copy()) for p, t in blk.extras], blk.final_prefix())


def _ring_script(mod, reg):
    """The same sequence on one package's ring; the states after each step
    and the overflow count."""
    ring = mod.TableRing(*SHAPE, depth=2)
    before = reg.counter("serve_ring_overflow_total").value
    blk = ring.open_block(0, 3)
    states = []
    slots = [blk.acquire() for _ in range(3)]
    assert blk.acquire() is None  # full: overflow
    slots[1].write(_table(seed=1))
    slots[0].write(_table(seed=0))
    states.append(_ring_state(blk))  # nothing final yet
    blk.commit(slots[0], 2)
    states.append(_ring_state(blk))
    slots[2].write(_table(seed=2))
    blk.reject(slots[2])  # zeroed back, final
    states.append(_ring_state(blk))
    assert not blk.wait_final(0.01)  # slot 1 still in flight
    blk.commit(slots[1], 0)
    assert blk.wait_final(0.01)
    blk.add_extra(1, _table(7.0))
    states.append(_ring_state(blk))
    count, pos, valid, extras = blk.snapshot()
    states.append((count, pos, valid, [(p, t.copy()) for p, t in extras]))
    ring.release(blk)
    again = ring.open_block(1, 3)  # the pooled block, zeroed
    states.append((again is blk, _ring_state(again)))
    other = ring.open_block(2, 5)  # another capacity: a new block
    states.append((other is blk, other.tables.shape))
    return states, reg.counter("serve_ring_overflow_total").value - before


def _equal_nested(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_nested(x, y)
    else:
        assert a == b, (a, b)


def test_ring_matches_reference():
    from commefficient_tpu.obs import registry as jreg

    want, jover = _ring_script(jring, jreg.default())
    got, tover = _ring_script(tring, obreg.default())
    _equal_nested(got, want)
    assert jover == tover == 1


def test_ring_counts_its_blocks_and_drops_past_its_depth():
    ring = tring.TableRing(*SHAPE, depth=1)
    a, b = ring.open_block(0, 2), ring.open_block(1, 2)
    ring.release(a)
    ring.release(b)  # past the depth: dropped
    assert ring.open_block(2, 2) is a and ring.allocated == 2
    assert isinstance(a.host, torch.Tensor) and not a.host.is_pinned()
    assert a.tables.ctypes.data == a.host.data_ptr()  # one buffer, two views


# ---------------------------------------------------------- the gauntlet


def _policy(mod, clip=0.0, median=None):
    return mod.PayloadPolicy(rows=SHAPE[0], cols=SHAPE[1], clip_multiple=clip,
                             quarantine_median=None if median is None else (lambda: median))


def _subs(mod, frames):
    return [mod.Submission(cid, 0, 0.1, payload=f) for cid, f in frames]


def _frames(pay):
    nan_t = _table()
    nan_t[0, 0] = np.nan
    good = pay.encode_frame(_table(0.1))
    return [(1, good), (2, pay.encode_frame(nan_t)), (3, pay.encode_frame(_table(100.0))),
            (4, {**pay.encode_frame(_table(0.2)), "schema": 99}), (1, good),
            (9, pay.encode_frame(_table(0.3))), (5, "garbage"), (6, pay.encode_frame(_table(0.4)))]


def _gauntlet_run(ing, gmod, rmod, pay):
    q = ing.IngestQueue(capacity=16, payload_policy=_policy(ing, clip=2.0, median=1.0))
    q.open_round(0, [1, 2, 3, 4, 5, 6])
    q.attach_block(0, rmod.TableRing(*SHAPE).open_block(0, 4))
    pool = gmod.GauntletPool(q, workers=2).start()
    subs = _subs(ing, _frames(pay))
    got = [pool.submit_and_wait(s) for s in subs[:4]]
    box = []
    done = threading.Event()

    def deliver(status, i):
        box.append((i, status))
        if len(box) == len(subs) - 4:
            done.set()

    for i, s in enumerate(subs[4:]):
        pool.submit(s, lambda st, i=i: deliver(st, i))
    assert done.wait(10.0)
    got += [st for _, st in sorted(box)]
    pool.stop()
    late = [pool.submit_and_wait(subs[-1])]
    pool.submit(subs[-1], late.append)
    return got, late, q.counters()


def test_gauntlet_pool_verdicts_match_reference_and_close_after_stop():
    want = _gauntlet_run(jingest, jgauntlet, jring, jpayload)
    got = _gauntlet_run(tingest, tgauntlet, tring, tpayload)
    assert got == want
    statuses, late, counters = got
    assert statuses == [tingest.ACCEPTED, tingest.QUARANTINED, tingest.QUARANTINED,
                        tingest.STALE_SCHEMA, tingest.DUPLICATE, tingest.NOT_INVITED,
                        tingest.MALFORMED, tingest.ACCEPTED]
    assert late == [tingest.CLOSED, tingest.CLOSED]
    assert counters["accepted"] == 2 and counters["rejected_quarantined"] == 2


def test_gauntlet_pool_failed_batch_answers_every_waiter(capfd):
    class Broken:
        def submit_block(self, subs):
            raise RuntimeError("boom")

    pool = tgauntlet.GauntletPool(Broken(), workers=1).start()
    got = []
    pool.submit(object(), got.append)
    assert pool.submit_and_wait(object()) == tingest.CLOSED
    pool.stop()
    assert got == [tingest.CLOSED]
    assert "gauntlet batch failed (RuntimeError('boom'))" in capfd.readouterr().err


def _screen_entries(ing, rmod, pay):
    """Slot-backed and standalone entries over two ring blocks: finite,
    NaN, inf, over and under the L2 screen, a zero median."""
    blocks = [rmod.TableRing(*SHAPE).open_block(0, 4), rmod.TableRing(*SHAPE).open_block(1, 3)]
    tables = [_table(seed=s) for s in range(5)] + [_table(100.0), _table(0.0), _table(3.0)]
    tables[2][1, 3] = np.nan
    tables[4][0, 0] = np.inf
    entries = []
    for i, t in enumerate(tables):
        if i == 7:
            entries.append((t, 1.0, None, -1))  # the ring overflowed: alone
            continue
        blk = blocks[i % 2]
        slot = blk.acquire()
        if slot is None:
            entries.append((t, 1.0, None, -1))
            continue
        entries.append((slot.write(t), [1.0, 0.0, 2.5][i % 3], blk, slot.index))
    return entries


@pytest.mark.parametrize("clip", [0.0, 1.5])
def test_screen_block_matches_reference_and_the_scalar_screen(clip):
    want = jingest.screen_block(_screen_entries(jingest, jring, jpayload),
                                _policy(jingest, clip=clip, median=7.0))
    entries = _screen_entries(tingest, tring, tpayload)
    policy = _policy(tingest, clip=clip, median=7.0)
    got = tingest.screen_block(entries, policy)
    assert got == want
    assert got == [tingest._screen_table(t, policy, med)[1:] for t, med, _, _ in entries]
    assert {d for d, _ in got} == ({tingest.ACCEPTED, tingest.QUARANTINED})


# ------------------------------------------- damaged frames inside a block


def _one_round(session, params_of, ing, asm, pay, rmod, mutate=None, batched=False, target=2):
    """tests/test_serve.py's ``_one_payload_round`` in either package, with a
    ring block attached: every invitee submits its table as a frame, the
    target's damaged by ``mutate``; through one ``submit_block`` or one
    ``submit`` each. Returns (params, statuses, counters)."""
    ids = session.sample_cohort(0)
    prep0 = session.prepare_served_round(0, ids, np.ones(len(ids), np.float32))
    tables, aux = session.compute_client_tables(prep0)
    q = ing.IngestQueue(capacity=16, payload_policy=_policy(ing))
    q.open_round(0, ids)
    ring = rmod.TableRing(*SHAPE)
    q.attach_block(0, ring.open_block(0, len(ids)))
    a = asm.CohortAssembler(q, len(ids), 10.0, payload_shape=SHAPE)
    subs = []
    for i, cid in enumerate(ids):
        frame = pay.encode_frame(np.asarray(tables[i]))
        sent = mutate(frame) if i == target and mutate is not None else frame
        subs += [ing.Submission(int(cid), 0, 0.1, payload=p)
                 for p in (sent if isinstance(sent, list) else [sent]) if p is not None]
    statuses = q.submit_block(subs) if batched else [q.submit(s) for s in subs]
    closed = a.close_virtual(0, ids)
    prep = session.finish_served_payload(prep0, closed.arrived, closed.tables, aux)
    session.commit_round(session.dispatch_round(prep, LR))
    return params_of(session), statuses, q.counters()


def _tparams(s):
    return s.state["params"].numpy().copy()


def _jparams(s):
    import jax

    return np.asarray(ravel_pytree(jax.device_get(s.state["params"]))[0])


# the reference's damage kinds, applied by each package's own fault plan
DAMAGE = sorted(jserve.DAMAGE)


def _damage(kind, plan):
    return {"corrupt": plan.corrupt_frame, "truncate": plan.truncate_frame,
            "stale_schema": lambda f: {**f, "schema": tpayload.SCHEMA_VERSION + 7},
            "wrong_shape": lambda f: {**f, "shape": [1, 1]},
            "garbage": lambda f: "not a frame at all",
            "dropped_mid_send": lambda f: None}[kind]


@pytest.mark.parametrize("kind", DAMAGE)
def test_damaged_frame_inside_batched_block_matches_reference(kind):
    from commefficient_tpu.serve import assembler as jassembler

    jp, jst, jc = _one_round(jserve._sketch_session(), _jparams, jingest, jassembler, jpayload,
                             jring, jserve.DAMAGE[kind], batched=True)
    plan = _damage(kind, TFaultPlan)
    tp, tst, tc = _one_round(_tsession(), _tparams, tingest, tassembler, tpayload, tring, plan,
                             batched=True)
    assert tst == jst and tc == jc
    np.testing.assert_allclose(tp, jp, rtol=0, atol=ATOL)
    # the batched path is bitwise the scalar path, and the rejection a drop
    sp, sst, sc = _one_round(_tsession(), _tparams, tingest, tassembler, tpayload, tring, plan)
    np.testing.assert_array_equal(tp, sp)
    assert sst == tst and sc == tc
    dropped, _, _ = _one_round(_tsession(), _tparams, tingest, tassembler, tpayload, tring,
                               lambda f: None, batched=True)
    np.testing.assert_array_equal(tp, dropped)


def test_duplicated_frame_inside_batched_block_is_counted_once():
    dup, st, c = _one_round(_tsession(), _tparams, tingest, tassembler, tpayload, tring,
                            lambda f: [f, f], batched=True)
    clean, _, _ = _one_round(_tsession(), _tparams, tingest, tassembler, tpayload, tring)
    np.testing.assert_array_equal(dup, clean)
    assert st.count(tingest.DUPLICATE) == 1 and c["rejected_dup"] == 1


# ------------------------------------------ the service: fast == slow


def _serve(session, cfg, rounds):
    """``rounds`` served rounds through the run loop: (metrics, service,
    the registry's mark from just before); the validated stack each round
    merged lands in ``session.stacks``, as numpy."""
    metrics = []
    commit, finish = session.commit_rounds, session.finish_served_payload
    session.stacks = []

    def recording(infls, hosts):
        out = commit(infls, hosts)
        metrics.extend(out)
        return out

    def keep_stack(prep0, arrived, wire_tables, aux, stale=None):
        session.stacks.append(np.array(wire_tables, np.float32, copy=True))
        return finish(prep0, arrived, wire_tables, aux, stale=stale)

    session.commit_rounds = recording
    session.finish_served_payload = keep_stack
    svc = tservice.AggregationService(
        session, cfg, traffic=ttraffic.TrafficGenerator(
            ttraffic.TraceConfig(population=12, seed=5), classes=RELIABLE)).start()
    # the admission counters as each served round closed, for the pins: a
    # pipeline's worker may serve a round past the end before its stop, or
    # may not, and that round's admissions count
    svc.counters_at = {}
    serve_round = svc.serve_round

    def recording_counters(rnd):
        out = serve_round(rnd)
        svc.counters_at[rnd] = svc.queue.counters()
        return out

    svc.serve_round = recording_counters
    mark = obreg.default().mark()
    try:
        run_loop(session, FedOptimizer(lambda e: LR, 4),
                 RunnerConfig(total_rounds=rounds, eval_every=100, sync_loop=True),
                 source=svc.source())
    finally:
        svc.close()
        session.commit_rounds = commit
    return metrics, svc, mark


CASES = {
    "inproc": dict(quorum=4),
    "socket_eventloop": dict(quorum=4, transport="socket"),
    "socket_threaded": dict(quorum=4, transport="socket", socket_transport="threaded"),
    "async_buffer6": dict(async_mode=True, buffer_size=6),
    "pipelined": dict(quorum=4, pipeline=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fastpath_bitwise_equals_slow_path(case):
    kw = CASES[case]
    async_ = kw.get("async_mode", False)
    sess = dict(fault_plan=PLAN, clip=3.0, workers=8 if async_ else 4,
                stale_slots=8 if async_ else 0)
    cfg = tservice.ServeConfig(deadline_s=30.0, payload="sketch", **kw)
    rounds = 4 if async_ else 3
    a = _tsession(**sess)
    ma, svc_a, mark_a = _serve(a, dataclasses.replace(cfg, fastpath=True), rounds)
    bytes_fast = mark_a.delta("serve_table_bytes_copied_total")
    b = _tsession(**sess)
    mb, svc_b, mark_b = _serve(b, cfg, rounds)
    bytes_slow = mark_b.delta("serve_table_bytes_copied_total")
    _assert_state_equal(a, b)
    assert ma == mb
    assert list(a._requeue) == list(b._requeue)
    # the stack built from the ring is the close's host stack, bit for bit
    # (a pipeline's worker may serve a round past the end)
    assert min(len(a.stacks), len(b.stacks)) >= rounds
    for x, y in zip(a.stacks[:rounds], b.stacks[:rounds]):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    # the counters at the last committed round's close
    ca = svc_a.counters_at[rounds - 1]
    assert ca == svc_b.counters_at[rounds - 1]
    # the chaos went through the fast path's validation
    assert ca["rejected_malformed"] >= 1 and ca["rejected_quarantined"] >= 1, ca
    assert svc_a.registry.histogram("serve_ring_occupancy").count > 0
    assert svc_b.metrics_snapshot()["fastpath"] is None
    assert set(svc_a.metrics_snapshot()["fastpath"]) == {
        "gauntlet_workers", "gauntlet_batch_ms", "ring_occupancy", "ring_overflow",
        "bytes_copied"}
    if kw.get("transport") == "socket":
        assert svc_a.registry.histogram("serve_gauntlet_batch_ms").count > 0
        # one copy of a table against two (the decode and the close's stack)
        assert 0 < bytes_fast < bytes_slow, (bytes_fast, bytes_slow)
    if async_:
        assert any(m.get("stale_folded", 0) for m in ma), "no fold: the pin is vacuous"


def test_fastpath_ring_block_is_pooled_and_never_aliased():
    """Pipelined, two rounds are open at once: the pool holds their blocks
    (no more are made past the first rounds), and the stack a round merged
    is a tensor of its own, never a view of a block that ``reset`` zeroes
    for a later round."""
    s = _tsession(fault_plan=PLAN, clip=3.0)
    cfg = tservice.ServeConfig(quorum=4, deadline_s=30.0, payload="sketch", pipeline=True,
                               fastpath=True)
    stacks = []
    finish = s.finish_served_payload

    def keep(prep0, arrived, wire_tables, aux, stale=None):
        stacks.append((wire_tables, wire_tables.clone()))
        return finish(prep0, arrived, wire_tables, aux, stale=stale)

    s.finish_served_payload = keep
    _, svc, _ = _serve(s, cfg, 5)
    assert 1 <= svc._ring.allocated <= 2, svc._ring.allocated
    for live, snap in stacks:
        assert torch.equal(live, snap)  # no later reset rewrote it
    assert any(bool(live.abs().sum()) for live, _ in stacks)


def test_uploader_error_is_raised_by_the_round():
    s = _tsession()
    svc = tservice.AggregationService(
        s, tservice.ServeConfig(quorum=4, deadline_s=30.0, payload="sketch", fastpath=True),
        traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12, seed=5),
                                          classes=RELIABLE)).start()
    orig = tservice._RingUploader._ship_through

    def broken(self, ready):
        raise OSError("the copy failed")

    tservice._RingUploader._ship_through = broken
    try:
        with pytest.raises(OSError, match="the copy failed"):
            svc.source().next()
    finally:
        tservice._RingUploader._ship_through = orig
        svc.close()
    assert not svc._ring_blocks


# --------------------------------------- the port against the reference


@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_fastpath_run_matches_reference(transport):
    from commefficient_tpu.resilience import FaultPlan as JFaultPlan

    j = jserve._sketch_session(fault_plan=JFaultPlan.parse(PLAN), clip=3.0)
    jsvc, jdrops = jserve._serve_payload_rounds(j, 3, transport=transport, quorum=4,
                                                deadline=30.0, fastpath=True)
    t = _tsession(fault_plan=PLAN, clip=3.0)
    tsvc = tservice.AggregationService(
        t, tservice.ServeConfig(quorum=4, deadline_s=30.0, transport=transport,
                                payload="sketch", fastpath=True),
        traffic=ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12, seed=5),
                                          classes=RELIABLE)).start()
    src, tdrops = tsvc.source(), []
    try:
        for _ in range(3):
            prep = src.next()
            tdrops.append(sorted(int(p) for p in np.flatnonzero(prep.payload[1] == 0.0)))
            t.commit_round(t.dispatch_round(prep, LR))
    finally:
        tsvc.close()
    assert tdrops == jdrops
    assert tsvc.queue.counters() == jsvc.queue.counters()
    assert list(t._requeue) == list(j._requeue)
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)
    want = jsvc.metrics_snapshot()["fastpath"]
    got = tsvc.metrics_snapshot()["fastpath"]
    assert set(got) == set(want)
    assert set(got["ring_occupancy"]) == set(want["ring_occupancy"])
    assert got["gauntlet_workers"] == want["gauntlet_workers"] == 2


def test_fastpath_metrics_are_registered_at_zero():
    reg = obreg.Registry()
    tmetrics.register_fastpath(reg)
    text = tmetrics.render_prometheus(reg)
    for name, kind in tmetrics.FASTPATH_METRICS:
        line = f"{name}_count 0" if kind == "histogram" else f"{name} 0"
        assert line in text, (name, text)


def test_service_refuses_fastpath_as_the_reference_does():
    traffic = ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=12))
    s = _tsession()
    with pytest.raises(ValueError, match="--serve_fastpath accelerates"):
        tservice.AggregationService(s, tservice.ServeConfig(quorum=2, fastpath=True),
                                    traffic=traffic)
    with pytest.raises(ValueError, match="--serve_gauntlet_workers must be >= 1"):
        tservice.AggregationService(s, tservice.ServeConfig(quorum=2, payload="sketch",
                                                            fastpath=True, gauntlet_workers=0),
                                    traffic=traffic)
