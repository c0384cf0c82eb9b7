"""The load generator (``commefficient_tpu_torch/serve/scale/loadgen.py``)
on the CPU: one short closed-loop stage of 64 connections from 2 client
processes against thread shards and against process shards. Every
verdict a client read is counted (the verdicts add up to the
submissions, and the server decided as many, plus at most one in flight a
connection at the stage's end), the connections all open, and each
client process reports its descriptor cap."""

import pytest

from commefficient_tpu_torch.serve.ingest import IngestQueue
from commefficient_tpu_torch.serve.scale import loadgen
from commefficient_tpu_torch.serve.scale.procshard import ProcShardedIngest
from commefficient_tpu_torch.serve.scale.shard import ShardedIngest

CONNS, PROCS, STAGE_S = 64, 2, 2.0


def _stage(port: int, model: str) -> dict:
    cfg = loadgen.LoadGenConfig(port=port, processes=PROCS, stage_s=STAGE_S, model=model,
                                think_s=0.02, connections=CONNS, ramp_start=CONNS)
    return loadgen.run_stage(cfg, CONNS)


def _check(stage: dict, server_counts: dict) -> None:
    assert stage["processes"] == PROCS and stage["opened_conns"] == CONNS
    assert stage["errors"] == 0 and stage["submissions"] > CONNS
    assert sum(stage["statuses"].values()) == stage["submissions"]
    # the generator's ids lie outside every cohort: each is NOT_INVITED
    assert stage["statuses"] == {"NOT_INVITED": stage["submissions"]}
    # the server also decided what was in flight at the stage's end (at
    # most one submission a connection), whose verdicts no client read
    assert stage["submissions"] <= server_counts["rejected_uninvited"] <= \
        stage["submissions"] + CONNS
    assert stage["submissions_per_s"] == stage["submissions"] / STAGE_S
    assert stage["fd_cap_per_proc"] >= 16 and stage["fd_capped"] is False


@pytest.mark.parametrize("model", ["flat", "bursty"])
def test_stage_against_thread_shards(model):
    q = IngestQueue(capacity=64)
    tr = ShardedIngest(q, n_shards=2, read_deadline_s=10.0)
    tr.start()
    try:
        q.open_round(0, [1, 2])
        stage = _stage(tr.address[1], model)
        _check(stage, q.counters())
    finally:
        tr.stop()
        q.shutdown()


def test_stage_against_process_shards():
    t = ProcShardedIngest(n_shards=2, read_deadline_s=10.0)
    t.start()
    try:
        t.queue.open_round(0, [1, 2])
        stage = _stage(t.address[1], "diurnal")
        _check(stage, t.queue.counters())
        # the kernel spread the connections over both workers
        assert all(v["submissions"] > 0 for v in t.counters().values())
    finally:
        t.stop()


def test_ramp_doubles_toward_its_target_and_names_no_ceiling_below_the_cap():
    cfg = loadgen.LoadGenConfig(port=1, processes=1, connections=6, ramp_start=2)
    stages = []

    def fake_stage(c, conns):
        stages.append(conns)
        return {"submissions_per_s": float(conns), "opened_conns": conns, "errors": 0,
                "fd_capped": False, "fd_cap_per_proc": 100}

    orig, loadgen.run_stage = loadgen.run_stage, fake_stage
    try:
        out = loadgen.run_ramp(cfg, log=lambda *_: None)
    finally:
        loadgen.run_stage = orig
    assert stages == [2, 4, 6] and out["ceiling"] is None
    assert out["peak_submissions_per_s"] == 6.0 and out["max_opened_conns"] == 6


def test_stage_leaves_no_time_wait_and_the_rendezvous_port_is_held_everywhere():
    """A stage's connections close abortively: none is left in TIME_WAIT on
    the clients' loopback addresses (127.0.1.<w+1>), where it would hold its
    port for a minute. And the port ``distributed.reserve_port`` holds for a
    group's rendezvous is held on every address (a port free on 127.0.0.1
    alone could be taken on 127.0.1.x, and the store's bind on every
    address would then fail), while the store itself can still bind it."""
    import socket
    import subprocess

    from commefficient_tpu_torch.parallel import distributed

    q = IngestQueue(capacity=64)
    tr = ShardedIngest(q, n_shards=2, read_deadline_s=10.0)
    tr.start()
    try:
        q.open_round(0, [1])
        cfg = loadgen.LoadGenConfig(port=tr.address[1], processes=PROCS, stage_s=1.0,
                                    model="flat")
        assert loadgen.run_stage(cfg, 256)["opened_conns"] == 256
    finally:
        tr.stop()
        q.shutdown()
    waits = subprocess.run(["ss", "-tan", "state", "time-wait", "src", "127.0.1.0/24"],
                           capture_output=True, text=True).stdout.splitlines()[1:]
    assert waits == [], waits[:5]
    held = distributed.reserve_port()
    try:
        port = held.getsockname()[1]
        other = socket.socket()
        with pytest.raises(OSError):
            other.bind(("127.0.1.1", port))
        other.close()
        store = socket.socket()
        store.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        store.bind(("", port))  # the rendezvous store's bind
        store.listen(1)
        store.close()
    finally:
        held.close()
