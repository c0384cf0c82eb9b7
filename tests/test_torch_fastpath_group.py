"""``--serve_fastpath`` on a group of ranks, on the CPU: two gloo ranks
started by ``distributed.launch_local``. Rank 0's service builds each
payload round's stack from its table ring and broadcasts that stack (not
the close's host stack, which ring mode leaves None); the follower merges
those bits. Every rank of a 2-rank fast-path run equals the one-device
fast-path run at ``client_shards`` 2 **bitwise**, over 4 rounds: the
server state, every committed metric and the requeue with its ages, in the
sync payload round (the clip, a ``wire_corrupt`` client and a no-show) and
the pipelined buffered-async round (buffer 6 of 8, stragglers folded a
round later), and the sync payload round over process shards (rank 0
serves through 2 worker processes and their shared-memory ring blocks, and
broadcasts the stack it scattered from them); rank 0's admission counters
equal the twin's.

The rank function lives here at module level (``launch_local`` pickles it
by name); this module imports no JAX, so the ranks do not."""

import dataclasses
import os

import pytest
import torch

from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as meshlib
from commefficient_tpu_torch.serve import service as tservice
from test_torch_group_client_state import _session
from test_torch_group_serve import (ASYNC, NUM_CLIENTS, PAYLOAD, ROUNDS, SKETCH, W,
                                    _assert_equals_twin, _serve, _snap)

torch.set_num_threads(2)

WORLD = 2
KW = dict(wire_payloads=True, client_update_clip=3.0, fault_plan="wire_corrupt@1:clients=0")
CASES = {
    "payload": (KW, dataclasses.replace(PAYLOAD, fastpath=True)),
    "async_pipelined": (dict(KW, stale_slots=W),
                        dataclasses.replace(ASYNC, fastpath=True, pipeline=True)),
    # rank 0's ingest: 2 SO_REUSEPORT worker processes over shared-memory
    # ring blocks (the followers' configuration names them too, and they
    # start none)
    "payload_process_shards": (KW, dataclasses.replace(
        PAYLOAD, fastpath=True, transport="socket", shards=2, shard_mode="process")),
}


def _ranks(out_dir):
    """Rank function: every case served on the group."""
    distributed.initialize(force=True, device="cpu")
    got = {}
    for name, (kw, cfg) in CASES.items():
        s = _session(NUM_CLIENTS, SKETCH, mesh=meshlib.ClientMesh(clients=WORLD), **kw)
        metrics, svc = _serve(s, cfg)
        got[name] = _snap(s, metrics, svc)
        svc.close()
    torch.save(got, os.path.join(out_dir, f"fast_{distributed.rank()}.pt"))


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("fastpath_group")
    codes = distributed.launch_local(_ranks, WORLD, (str(out),), timeout_s=300)
    assert codes == [0] * WORLD, codes
    return [torch.load(out / f"fast_{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_group_fastpath_equals_the_one_device_fastpath_run_bitwise(group_run, name):
    kw, cfg = CASES[name]
    t = _session(NUM_CLIENTS, SKETCH, client_shards=WORLD, **kw)
    metrics, svc = _serve(t, dataclasses.replace(cfg, pipeline=False))
    svc.close()
    assert svc._ring.allocated >= 1 if svc._proc is None else svc._proc.shm_bytes == 0
    for r, got in enumerate(group_run):
        _assert_equals_twin(got[name], t, metrics, svc, f"{name} rank {r}")
    if not cfg.pipeline:
        # a pipeline's worker serves a round past the end before its stop
        assert group_run[0][name]["counters"] == svc.queue.counters()
    assert group_run[1][name]["counters"] is None
    c = svc.queue.counters()
    assert c["rejected_malformed"] >= 1, c
    assert sum(m["clients_dropped"] for m in metrics) >= 2, metrics
    if cfg.async_mode:
        assert any(m.get("stale_folded", 0) for m in metrics), "no fold: the pin is vacuous"
    assert ROUNDS == len(metrics)
