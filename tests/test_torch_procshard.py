"""The sharded ingest over worker processes (``--serve_shard_mode
process``: ``commefficient_tpu_torch/serve/scale/procshard.py``,
``procshard_worker.py``, ``shmring.py``) and the ``shard_kill`` fault
kind, on the CPU.

Within the port, bitwise: a served payload run through N SO_REUSEPORT
worker processes (the fast path's shared-memory ring blocks on and off, at
``client_shards`` 1 and 2) equals the thread-sharded run and the
one-listener socket run of the same session (params, optimizer state,
every metric row, each round's merged stack, the admission counters, the
requeue); ``shard_kill`` equals a ``client_drop`` of the dead shard's
cohort positions, with the casualties requeued. Against the JAX package
(tests/test_procshard.py's pins, and tests/test_serve.py's session): a
process-sharded run within atol 1e-5 of the reference's one-listener run,
and a port ``shard_kill`` run within atol 1e-5 of the reference's
``shard_kill`` run, with the same casualties.

Also: shard-owned dedup and misroute forwarding; ``/dev/shm`` unchanged
after a normal close, a stop with a round open and a SIGKILLed worker
(and no leak warning at the process's exit); respawn at the next open;
per-shard counters across the process boundary in ``/metrics`` and
``/metrics.prom``; the worker's ready handshake (no torch, no jax), a
worker that never reports ready, a segment ``/dev/shm`` cannot hold and a
failed CUDA registration, each raising; both CLIs with process shards and
``shard_kill``."""

import dataclasses
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import test_serve as jserve
from commefficient_tpu_torch import cv_train, gpt2_train
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.obs import registry as obreg
from commefficient_tpu_torch.resilience import FaultPlan
from commefficient_tpu_torch.serve import ring as tring
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve.ingest import ACCEPTED, DUPLICATE, Submission
from commefficient_tpu_torch.serve.scale import procshard
from commefficient_tpu_torch.serve.scale.procshard import ProcShardedIngest
from commefficient_tpu_torch.serve.scale.shard import shard_for
from commefficient_tpu_torch.serve.scale.shmring import ShmRingBlock
from commefficient_tpu_torch.serve.transport import submit_over_socket
from test_torch_async_serve import CV_CLI, GPT2_CLI
from test_torch_fastpath import ATOL, PLAN, _jparams, _quad_paths, _serve, _tparams  # noqa: F401
from test_torch_fastpath import _tsession
from test_torch_runner import _assert_state_equal, tiny_cv  # noqa: F401
from test_torch_shard import _traffic, trun

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FLAX_PATH = convert.flax_path
BASE = tservice.ServeConfig(deadline_s=30.0, payload="sketch", quorum=4, transport="socket")
PROC = dict(shards=2, shard_mode="process")


def _shm_names() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except FileNotFoundError:
        return set()


def _served(session, cfg, rounds=3):
    """(metric rows, params, each round's merged stack, the counters at the
    last round's close, the committed requeue) of a served run."""
    metrics, svc, _ = _serve(session, cfg, rounds)
    return (metrics, session.state["params"].clone(), session.stacks[:rounds],
            svc.counters_at[rounds - 1], list(session._requeue)), svc


# -------------------------------- process == thread == one listener, bitwise


@pytest.mark.parametrize("client_shards", [0, 2])
@pytest.mark.parametrize("fastpath", [False, True])
def test_proc_shards_equal_thread_shards_and_one_listener_bitwise(fastpath, client_shards):
    runs, sessions = {}, {}
    for name, kw in (("one", {}), ("thread", dict(shards=2)), ("process", PROC)):
        s = sessions[name] = _tsession(fault_plan=PLAN, clip=3.0, shards=client_shards)
        runs[name], svc = _served(s, dataclasses.replace(BASE, fastpath=fastpath, **kw))
    # the root ran no ring pool of its own, and no worker died
    assert svc._ring is None and not svc._proc.respawns
    one = runs["one"]
    for name in ("thread", "process"):
        _assert_state_equal(sessions[name], sessions["one"])
        got = runs[name]
        assert got[0] == one[0], name
        assert torch.equal(got[1], one[1]), name
        for x, y in zip(got[2], one[2], strict=True):
            np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
        assert got[3] == one[3] and got[4] == one[4], name
    assert one[3]["rejected_malformed"] >= 1 and one[3]["rejected_quarantined"] >= 1


def test_proc_sharded_run_matches_reference_one_listener():
    from commefficient_tpu.resilience import FaultPlan as JFaultPlan

    j = jserve._sketch_session(fault_plan=JFaultPlan.parse(PLAN), clip=3.0)
    jsvc, jdrops = jserve._serve_payload_rounds(j, 3, transport="socket", quorum=4,
                                                deadline=30.0)
    t = _tsession(fault_plan=PLAN, clip=3.0)
    tsvc, tdrops = trun(t, dataclasses.replace(BASE, fastpath=True, **PROC), 3)
    assert tdrops == jdrops and any(tdrops)
    assert tsvc.queue.counters() == jsvc.queue.counters()
    assert list(t._requeue) == list(j._requeue)
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)


# ------------------------------------------------ shard-owned admission


def test_shard_owned_dedup_and_misroute_forwarding():
    """A retry on the owner is DUPLICATE; through the shared SO_REUSEPORT
    port the kernel spreads connections blind to ownership (misroutes
    counted and forwarded to the owner), and the retries are still
    DUPLICATE, because the one owner decides."""
    t = ProcShardedIngest(n_shards=2)
    try:
        t.start()
        ids = list(range(100, 148))
        t.queue.open_round(0, ids)
        assert t.submit(Submission(client_id=100, round=0, latency_s=0.1)) == ACCEPTED
        assert t.submit(Submission(client_id=100, round=0, latency_s=0.1)) == DUPLICATE
        # 32 submissions over 2 shards: no misroute at all has odds 2^-32
        for want in (ACCEPTED, DUPLICATE):
            for cid in ids[1:33]:
                assert submit_over_socket(
                    t.address, Submission(client_id=cid, round=0, latency_s=0.1)) == want
        assert sum(s["misrouted"] for s in t.counters().values()) > 0
        merged = t.queue.close_round(0)
        assert sorted(a.client_id for a in merged) == ids[:33]
        # the receive orders' residues are disjoint across shards
        assert len({a.recv_order for a in merged}) == len(merged)
        assert [a.recv_order % 2 for a in merged] == [shard_for(a.client_id, 2) for a in merged]
    finally:
        t.stop()


def test_concurrent_submissions_through_the_shared_port_land_once():
    """More submitting threads than cores, the interpreter switching often:
    every table pushed twice through the shared SO_REUSEPORT port (misroutes
    forwarded) is admitted exactly once by its owner and lands in exactly
    one committed slot of its shard's block, byte for byte, at its cohort
    position."""
    import threading

    n, threads = 32, 2 * (os.cpu_count() or 1) + 2
    tables = {cid: np.random.RandomState(cid).standard_normal((3, 16)).astype(np.float32)
              for cid in range(n)}
    t = ProcShardedIngest(n_shards=2, payload_shape=(3, 16), fastpath=True)
    statuses: dict = {}
    lock = threading.Lock()

    def push(cids):
        for cid in cids:
            for _ in range(2):
                st = submit_over_socket(t.address, Submission(
                    client_id=cid, round=0, latency_s=0.1, payload=tables[cid]))
                with lock:
                    statuses.setdefault(cid, []).append(st)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        t.start()
        t.queue.open_round(0, list(range(n)))
        workers = [threading.Thread(target=push, args=(list(range(k, n, threads)),))
                   for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60.0)
        assert not any(w.is_alive() for w in workers)
        merged = t.queue.close_round(0)
        blocks = t.ring_blocks()
        for k, b in enumerate(blocks):
            assert b.wait_final(5.0)
            count, pos, valid, extras = b.snapshot()
            owned = [c for c in range(n) if shard_for(c, 2) == k]
            got = sorted(int(p) for p, v in zip(pos[:count], valid[:count]) if v)
            assert got == owned and not extras
            for i in np.flatnonzero(valid[:count]):
                np.testing.assert_array_equal(b.tables[i], tables[int(pos[i])])
    finally:
        sys.setswitchinterval(interval)
        t.stop()
    assert sorted(a.client_id for a in merged) == list(range(n))
    assert all(sorted(v) == [ACCEPTED, DUPLICATE] for v in statuses.values())
    assert len(statuses) == n


# ----------------------------------------------------- the shm ring


def test_shm_block_speaks_the_ring_protocol():
    """A worker's writes through its mapping read back through the root's,
    step for step as a RingBlock's own."""
    root = ShmRingBlock.create(3, 8, 3)
    worker = ShmRingBlock.attach(root.name, 3, 8, 3)
    ref = tring.RingBlock(3, 8, 3)
    try:
        for b in (root, ref):
            b.reset(5)
        t1 = np.random.RandomState(0).standard_normal((3, 8)).astype(np.float32)
        last = {}
        for b in (worker, ref):
            s0, s1, last[b] = b.acquire(), b.acquire(), b.acquire()
            assert b.acquire() is None
            s0.write(t1)
            b.commit(s0, 2)
            s1.write(t1 + 1)
            b.reject(s1)
            b.add_extra(1, t1 * 2)
        assert root.final_prefix() == ref.final_prefix() == 2
        assert not root.wait_final(0.01)
        for b in (worker, ref):
            last[b].write(t1 - 1)
            b.commit(last[b], 0)
        assert root.wait_final(1.0) and root.final_prefix() == 3
        root.adopt_extras(worker.extras)
        (cr, pr, vr, er), (cw, pw, vw, ew) = root.snapshot(), ref.snapshot()
        assert cr == cw == 3
        np.testing.assert_array_equal(pr, pw)
        np.testing.assert_array_equal(vr, vw)
        np.testing.assert_array_equal(root.tables, ref.tables)
        assert [(p, t.tolist()) for p, t in er] == [(p, t.tolist()) for p, t in ew]
    finally:
        worker.close()
        root.close()
        root.unlink()
    assert root.name.lstrip("/") not in _shm_names()


@pytest.mark.parametrize("path", ["normal", "round_open", "worker_killed"])
def test_shm_ring_cleanup_on_every_exit_path(path):
    """(Other test processes may make segments meanwhile: the pin is on this
    ingest's own.)"""
    t = ProcShardedIngest(n_shards=2, payload_shape=(3, 16), fastpath=True)
    t.start()
    try:
        t.queue.open_round(0, list(range(12)))
        made = {b.name for b in t.ring_blocks()}
        assert t.shm_bytes > 0 and len(made) == 2 and made <= _shm_names()
        if path == "worker_killed":
            t.kill_shard(1)
        if path != "round_open":
            t.queue.close_round(0)
    finally:
        t.stop()
    assert not made & _shm_names()


def test_killed_worker_leaves_no_segment_and_no_leak_warning():
    """A process whose worker was SIGKILLed mid-round exits with /dev/shm as
    it found it and no resource-tracker warning (the root alone unlinks;
    a worker's mapping is not tracked)."""
    code = (
        "from commefficient_tpu_torch.serve.scale.procshard import ProcShardedIngest\n"
        "t = ProcShardedIngest(n_shards=2, payload_shape=(3, 16), fastpath=True)\n"
        "t.start()\n"
        "t.queue.open_round(0, list(range(12)))\n"
        "print(' '.join(b.name for b in t.ring_blocks()))\n"
        "t.kill_shard(0)\n"
        "t.queue.close_round(0)\n"
        "t.queue.open_round(1, list(range(12)))\n"
        "t.stop()\n"
        "print('done')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "done" in proc.stdout, proc.stderr
    assert "leaked" not in proc.stderr and "resource_tracker" not in proc.stderr, proc.stderr
    made = set(proc.stdout.split()[:2])
    assert len(made) == 2 and not made & _shm_names()


def test_segments_that_do_not_fit_raise_naming_the_bytes(monkeypatch):
    monkeypatch.setattr(procshard, "shm_free_bytes", lambda: 1000)
    t = ProcShardedIngest(n_shards=2, payload_shape=(3, 16), fastpath=True)
    t.start()
    try:
        with pytest.raises(RuntimeError, match=r"need \d+ bytes; /dev/shm has 1000 bytes free"):
            t.queue.open_round(0, list(range(12)))
    finally:
        t.stop()


def test_failed_host_registration_raises(monkeypatch):
    """On the GPU a segment is registered with CUDA before any
    copy; a registration that fails raises (no pageable fallback)."""
    class _Cudart:
        def cudaHostRegister(self, ptr, nbytes, flags):
            return 2  # cudaErrorMemoryAllocation

    monkeypatch.setattr(torch.cuda, "cudart", lambda: _Cudart())
    block = ShmRingBlock.create(3, 8, 4)
    try:
        with pytest.raises(RuntimeError, match="cudaHostRegister .* failed"):
            tservice._shm_host_view(block, torch.device("cuda"))
        assert not block.before_close
        tservice._shm_host_view(block, torch.device("cpu"))
        block.tables[1] = 3.0
        assert float(block.host[1].sum()) == 3.0 * 24
    finally:
        block.close()
        block.unlink()
    assert block.host is None


# ------------------------------------------------------ the workers' life


def test_worker_handshake_and_the_ready_timeout():
    t = ProcShardedIngest(n_shards=2)
    t.start()
    try:
        assert all(w.alive and w.spawn_s > 0 for w in t.workers)
        # each worker reported the device runtimes it holds: none
        assert all(w.imported == [] for w in t.workers)
    finally:
        t.stop()
    assert not any(w.alive for w in t.workers)
    slow = ProcShardedIngest(n_shards=2, ready_timeout_s=0.001)
    with pytest.raises(RuntimeError, match="never reported ready"):
        slow.start()
    assert all(w.proc is None for w in slow.workers)


def test_worker_that_dies_before_ready_raises(monkeypatch):
    monkeypatch.setattr(procshard, "WORKER_TARGET", "os:getpid")
    with pytest.raises(RuntimeError, match="died before its ready handshake"):
        ProcShardedIngest(n_shards=2).start()


def test_dead_worker_respawns_at_next_open():
    t = ProcShardedIngest(n_shards=2)
    try:
        t.start()
        pid0 = t.workers[1].proc.pid
        t.queue.open_round(0, list(range(8)))
        t.kill_shard(1)
        assert not t.workers[1].alive
        t.queue.close_round(0)
        t.queue.open_round(1, list(range(8)))
        assert t.workers[1].alive and t.workers[1].proc.pid != pid0
        assert [k for k, _ in t.respawns] == [1]
        owned = next(c for c in range(8) if shard_for(c, 2) == 1)
        assert t.submit(Submission(client_id=owned, round=1, latency_s=0.1)) == ACCEPTED
        assert [a.client_id for a in t.queue.close_round(1)] == [owned]
    finally:
        t.stop()


def test_cross_process_counters_aggregate_into_metrics():
    captured = {}

    def grab(svc):
        host, port = svc.metrics_server.address
        for path in ("metrics", "metrics.prom"):
            with urllib.request.urlopen(f"http://{host}:{port}/{path}", timeout=5) as r:
                captured[path] = r.read().decode()

    s = _tsession(fault_plan=PLAN, clip=3.0)
    svc = tservice.AggregationService(s, dataclasses.replace(BASE, metrics_port=0, **PROC),
                                      traffic=_traffic()).start()
    try:
        src = svc.source()
        for _ in range(2):
            s.commit_round(s.dispatch_round(src.next(), 0.05))
        grab(svc)
    finally:
        svc.close()
    snap = json.loads(captured["metrics"])
    # the deaths the process-wide registry counted (none in this run)
    assert snap["shard_mode"] == "process" and isinstance(snap["shard_deaths"], int)
    assert set(snap["shards"]) == {"0", "1"}
    assert all(v["alive"] and v["pid"] for v in snap["shards"].values())
    assert snap["submissions"]["accepted"] > 0
    assert sum(v["submissions"] for v in snap["shards"].values()) >= \
        snap["submissions"]["accepted"]
    for k in range(2):
        assert f"serve_shard{k}_submissions_total" in captured["metrics.prom"]


# ------------------------------------------ shard_kill == client_drop, bitwise

KILL_ROUND, DEAD = 1, 1


def _doomed(shards: int = 0) -> list:
    """The cohort positions of round KILL_ROUND that shard DEAD owns (the
    cohort is a function of the session's sampling stream alone)."""
    probe = _tsession(shards=shards)
    ids = [probe.sample_cohort(r) for r in range(KILL_ROUND + 1)][-1]
    return [p for p, cid in enumerate(ids) if shard_for(int(cid), 2) == DEAD]


@pytest.mark.parametrize("fastpath", [False, True])
def test_shard_kill_equals_client_drop_bitwise(fastpath):
    doomed = _doomed()
    assert doomed, "the hash left the dead shard no client: the pin is vacuous"
    cfg = dataclasses.replace(BASE, fastpath=fastpath, **PROC)
    reg = obreg.default()
    mark = reg.mark()
    a = _tsession(fault_plan=f"shard_kill@{KILL_ROUND}:shards={DEAD}")
    ra, svc_a = _served(a, cfg)
    kill = mark.delta("serve_shard_deaths_total"), mark.delta("resilience_fault_shard_kill_total")
    b = _tsession(fault_plan=f"client_drop@{KILL_ROUND}:clients="
                  + "+".join(map(str, doomed)))
    rb, _ = _served(b, cfg)
    assert kill == (1, 1)
    _assert_state_equal(a, b)
    assert ra[0] == rb[0] and ra[4] == rb[4]
    assert ra[0][KILL_ROUND]["clients_dropped"] >= len(doomed)
    assert ra[0][KILL_ROUND]["requeue_depth"] >= len(doomed)
    # the worker came back at the next open
    assert [k for k, _ in svc_a._proc.respawns] == [DEAD]


def test_shard_kill_matches_reference_shard_kill():
    from commefficient_tpu.resilience import FaultPlan as JFaultPlan
    from commefficient_tpu.serve import service as jservice
    from commefficient_tpu.serve import traffic as jtraffic

    plan = f"shard_kill@{KILL_ROUND}:shards={DEAD}"
    j = jserve._sketch_session(fault_plan=JFaultPlan.parse(plan))
    jsvc = jservice.AggregationService(
        j, jservice.ServeConfig(quorum=4, deadline_s=30.0, transport="socket",
                                payload="sketch", **PROC),
        traffic=jtraffic.TrafficGenerator(jtraffic.TraceConfig(population=12, seed=5),
                                          classes=jserve.RELIABLE_CLASSES)).start()
    src, jdrops = jsvc.source(), []
    try:
        for _ in range(3):
            prep = src.next()
            jdrops.append(sorted(int(p) for p in np.flatnonzero(prep.payload[1] == 0.0)))
            j.commit_round(j.dispatch_round(prep, 0.05))
    finally:
        jsvc.close()
    t = _tsession(fault_plan=plan)
    _, tdrops = trun(t, dataclasses.replace(BASE, **PROC), 3)
    assert tdrops == jdrops and set(_doomed()) <= set(tdrops[KILL_ROUND])
    assert list(t._requeue) == [int(c) for c in j._requeue]
    np.testing.assert_allclose(_tparams(t), _jparams(j), rtol=0, atol=ATOL)


# ------------------------------------------------- config and plan guards


def test_process_mode_rejections():
    s = _tsession(stale_slots=2)
    for bad in (dict(async_mode=True, buffer_size=2), dict(pipeline=True)):
        with pytest.raises(ValueError, match="shard_mode process does not compose"):
            tservice.AggregationService(s, dataclasses.replace(BASE, **PROC, **bad),
                                        traffic=_traffic())
    with pytest.raises(ValueError, match="needs --serve_shards >= 2"):
        tservice.AggregationService(s, dataclasses.replace(BASE, shard_mode="process"),
                                    traffic=_traffic())
    with pytest.raises(ValueError, match="n_shards"):
        ProcShardedIngest(n_shards=1)


def test_shard_kill_plan_validation():
    plan = FaultPlan.parse("shard_kill@1:shards=1+3")
    assert plan.has_shard_kill()
    with pytest.raises(ValueError, match="never fire"):
        plan.validate_shard_context(False, 0)
    with pytest.raises(ValueError, match="never fire"):
        plan.validate_shard_context(True, 2)
    plan.validate_shard_context(True, 4)
    with pytest.raises(ValueError, match="never fire"):
        plan.validate_rounds(1)
    assert plan.shard_kill_plan(1) == (1, 3) and plan.shard_kill_plan(0) == ()
    for bad in ("shard_kill@1", "shard_kill@1:shards=-1", "shard_kill@1:clients=0"):
        with pytest.raises(ValueError, match="shard"):
            FaultPlan.parse(bad)


# ------------------------------------------------------------ both CLIs

SOCK = ["--serve", "socket", "--serve_transport", "eventloop"]
SHARDS = ["--serve_shards", "2", "--serve_shard_mode", "process"]


def test_cv_cli_shards_bitwise_one_listener(tiny_cv, capsys):  # noqa: F811
    one = cv_train.main(CV_CLI + SOCK)
    thread = cv_train.main(CV_CLI + SOCK + ["--serve_shards", "2"])
    mark = obreg.default().mark()
    fast = cv_train.main(CV_CLI + SOCK + SHARDS + ["--serve_fastpath"])
    _assert_state_equal(one, thread)
    _assert_state_equal(one, fast)
    out = capsys.readouterr().out
    assert "2 ingest shards (process processes, SO_REUSEPORT + shm ring)" in out, out
    assert "'shard_mode': 'process'" in out and mark.delta("serve_shard_deaths_total") == 0
    killed = cv_train.main(CV_CLI + SOCK + SHARDS + ["--fault_plan", "shard_kill@1:shards=0"])
    assert killed.round == 3 and torch.isfinite(killed.state["params"]).all()
    assert mark.delta("serve_shard_deaths_total") == 1
    with pytest.raises(ValueError, match="shard_kill can never fire"):
        cv_train.main(CV_CLI + SOCK + ["--serve_shards", "2", "--fault_plan",
                                       "shard_kill@1:shards=0"])


def test_gpt2_cli_runs_process_shards_with_a_kill(capsys, monkeypatch):
    monkeypatch.setattr(convert, "flax_path", FLAX_PATH)  # GPT-2's own names
    argv = GPT2_CLI[:GPT2_CLI.index("--serve_async")]
    argv[argv.index("inproc")] = "socket"
    mark = obreg.default().mark()
    s = gpt2_train.main(argv + SHARDS + ["--fault_plan", "shard_kill@1:shards=1"])
    assert s.round == 2 and torch.isfinite(s.state["params"]).all()
    assert "2 ingest shards (process" in capsys.readouterr().out
    assert mark.delta("serve_shard_deaths_total") == 1
