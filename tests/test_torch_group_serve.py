"""``--serve`` on a group of ranks (``serve/service.py``: rank 0's
``AggregationService`` broadcasts each close, the other ranks'
``ServeFollower`` makes the same session calls without a transport), on
the CPU: four gloo ranks started by ``distributed.launch_local``, one
launch for the sessions and one for the CLIs.

What is held, and how exactly:

- every rank of a 4-rank served run equals the one-device served run at
  ``client_shards`` 4 (the emulation) **bitwise**, over 4 rounds: the
  server state (params, optimizer state, the quarantine's rings), every
  committed metric and the requeue with its ages, in the announce round of
  sketch (quorum 6 of 8 within 1 s, so rounds close short), local_topk
  (client rows included, each rank's block) and fedavg, and in the payload
  round with the clip, a ``wire_corrupt`` client and a no-show; rank 0's
  admission counters equal the twin's, and each rank sketches W / S tables
  a payload round; the same for the buffered-async payload round (buffer 6
  of 8, its stragglers folded a round later, by the sum and, pipelined, by
  the trimmed union stack), whose late tables cross in rank 0's broadcast;
- pipelined (``ServeConfig.pipeline``), local_topk and the payload round on
  the group equal the same twins bitwise;
- the agreed stop: a pipelined group stopped at round 2 leaves every
  worker joined and no rank in a collective (a broadcast on the serve
  group after the stop carries rank 0's value to every rank), and the same
  session and service continue to round 4 bitwise the twin;
- a group's round-2 checkpoint resumes on one device, and the one-device
  round-2 checkpoint on the group, each landing bitwise on the twin;
- the CV CLI on 4 ranks, pipelined payload with ``host_preempt@1:host=2``:
  every rank exits 75 at round 2, and ``--resume`` ends bitwise on the
  one-device CLI's checkpoint; rank 0 alone prints ``serve:`` lines, in the
  CV and the GPT-2 CLI.

The rank functions live here at module level (``launch_local`` pickles
them by name); this module imports no JAX at its top, so the ranks do
not."""

import contextlib
import dataclasses
import functools
import io
import os

import pytest
import torch
import torch.distributed as dist

from commefficient_tpu_torch import cv_train, gpt2_train
from commefficient_tpu_torch.federated.api import FederatedSession, FedOptimizer
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as meshlib
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE
from commefficient_tpu_torch.runner.loop import RunnerConfig, run_loop
from commefficient_tpu_torch.serve import service as tservice
from commefficient_tpu_torch.serve import traffic as ttraffic
from commefficient_tpu_torch.sketch import csvec
from commefficient_tpu_torch.utils import checkpoint as ckpt
from test_torch_distributed import _equal, _tiny_cli
from test_torch_group_client_state import FEDAVG, LOCAL, _session
from test_torch_runner import tiny_cv  # noqa: F401

torch.set_num_threads(2)

WORLD, W, NUM_CLIENTS, ROUNDS, LR = 4, 8, 16, 4, 0.05
MESH = meshlib.ClientMesh(clients=WORLD)
SKETCH = dict(mode="sketch", k=8, num_rows=3, num_cols=128, momentum=0.9,
              momentum_type="virtual", error_type="virtual")
ANNOUNCE = tservice.ServeConfig(quorum=6, deadline_s=1.0)
PAYLOAD = tservice.ServeConfig(quorum=8, deadline_s=30.0, payload="sketch")
ASYNC = dataclasses.replace(PAYLOAD, async_mode=True, buffer_size=6)
# name -> (mode, session knobs, service config); the trace's seed 5 has a
# no-show in the payload run besides the corrupt frame
CASES = {
    "announce_sketch": (SKETCH, {}, ANNOUNCE),
    "announce_local_topk": (LOCAL, {}, ANNOUNCE),
    "announce_fedavg": (FEDAVG, {}, ANNOUNCE),
    "payload_clip_corrupt": (SKETCH, dict(wire_payloads=True, client_update_clip=3.0,
                                          fault_plan="wire_corrupt@1:clients=0"), PAYLOAD),
    "pipelined_local_topk": (LOCAL, {}, dataclasses.replace(ANNOUNCE, pipeline=True)),
    "pipelined_payload": (SKETCH, dict(wire_payloads=True, client_update_clip=3.0,
                                       fault_plan="wire_corrupt@1:clients=0"),
                          dataclasses.replace(PAYLOAD, pipeline=True)),
    # the buffered-async service: rank 0 broadcasts each round's filled
    # stale slots, and every rank folds them (the sum; the trimmed union
    # stack, pipelined)
    "async_payload": (SKETCH, dict(wire_payloads=True, client_update_clip=3.0, stale_slots=W,
                                   fault_plan="wire_corrupt@1:clients=0"), ASYNC),
    "async_pipelined_trimmed": (SKETCH, dict(wire_payloads=True, client_update_clip=3.0,
                                             stale_slots=W, merge_policy="trimmed",
                                             merge_trim=1,
                                             fault_plan="wire_corrupt@1:clients=0"),
                                dataclasses.replace(ASYNC, pipeline=True)),
}


def _traffic():
    return ttraffic.TrafficGenerator(ttraffic.TraceConfig(population=NUM_CLIENTS, seed=5))


def _twin(mode, **kw):
    """The one-device twin of a group session: the emulation at S = 4 (set
    after construction for the modes outside the reference's scope)."""
    s = _session(NUM_CLIENTS, mode, **kw)
    s.cfg = dataclasses.replace(s.cfg, client_shards=WORLD)
    s._build_steps()
    return s


def _service(s, cfg):
    """Rank 0's service, or a follower (the one-device twin: the service)."""
    if s.group is not None and distributed.rank() != 0:
        return tservice.ServeFollower(s, cfg).start()
    return tservice.AggregationService(s, cfg, traffic=_traffic()).start()


def _serve(s, cfg, total=ROUNDS, svc=None):
    """Served rounds through the run loop up to ``total``: (metrics of each
    committed round, the service)."""
    metrics = []
    commit = s.commit_rounds

    def recording(infls, hosts):
        out = commit(infls, hosts)
        metrics.extend(out)
        return out

    s.commit_rounds = recording
    svc = svc or _service(s, cfg)
    try:
        run_loop(s, FedOptimizer(lambda e: LR, 4), RunnerConfig(total_rounds=total,
                                                                 eval_every=100),
                 source=svc.source())
    finally:
        s.commit_rounds = commit
    return metrics, svc


def _snap(s, metrics, svc=None):
    return {"state": {k: v for k, v in s.state.items() if k != "round"},
            "clients": s.client_state, "metrics": metrics, "round": s.round,
            "requeue": (list(s._requeue_committed), list(s._requeue_ages_committed),
                        list(s._requeue), dict(s._requeue_enqueued)),
            "counters": (svc.queue.counters() if isinstance(svc, tservice.AggregationService)
                         else None)}


def _counting():
    """Counts this process's sketches (the client tables of a payload
    round, and any other accumulate)."""
    calls = [0]
    sketch_vec = csvec.sketch_vec

    def counted(*a, **kw):
        calls[0] += 1
        return sketch_vec(*a, **kw)

    csvec.sketch_vec = counted
    return calls


def _session_ranks(out_dir):
    """Rank function: every case served on the group, the agreed stop, and
    the checkpoints both ways."""
    distributed.initialize(force=True, device="cpu")
    rank = dist.get_rank()
    calls = _counting()
    got = {}
    for name, (mode, kw, cfg) in CASES.items():
        s = _session(NUM_CLIENTS, mode, mesh=MESH, **kw)
        calls[0] = 0
        metrics, svc = _serve(s, cfg)
        got[name] = dict(_snap(s, metrics, svc), sketches=calls[0])
        svc.close()

    # the agreed stop: a pipelined group stopped at round 2, then the same
    # session and service on to round 4
    s = _session(NUM_CLIENTS, SKETCH, mesh=MESH)
    cfg = dataclasses.replace(ANNOUNCE, pipeline=True)
    m1, svc = _serve(s, cfg, total=2)
    workers = [t.name for t in __import__("threading").enumerate() if t.name == "serve-pipeline"]
    echo = distributed.broadcast_from_root([torch.tensor([100 + rank])],
                                           distributed.serve_group())[0]
    m2, _ = _serve(s, cfg, svc=svc)
    got["stopped"] = dict(_snap(s, m1 + m2), workers=workers, echo=int(echo[0]))
    svc.close()

    # checkpoints: the group's round 2 for a one-device resume; the
    # one-device round 2 resumed on the group
    s = _session(NUM_CLIENTS, SKETCH, mesh=MESH)
    _, svc = _serve(s, ANNOUNCE, total=2)
    if rank == 0:
        ckpt.save(os.path.join(out_dir, "group_ck"), s)
    svc.close()
    s = _session(NUM_CLIENTS, SKETCH, mesh=MESH)
    ckpt.restore(os.path.join(out_dir, "one_ck", "round_00000002"), s)
    metrics, svc = _serve(s, ANNOUNCE)
    got["from_one_device"] = _snap(s, metrics, svc)
    svc.close()
    torch.save(got, os.path.join(out_dir, f"serve_{rank}.pt"))


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("group_serve")
    # the one-device round-2 checkpoint the group resumes
    s = _session(NUM_CLIENTS, SKETCH, client_shards=WORLD)
    _, svc = _serve(s, ANNOUNCE, total=2)
    ckpt.save(str(out / "one_ck"), s)
    svc.close()
    codes = distributed.launch_local(_session_ranks, WORLD, (str(out),), timeout_s=300)
    assert codes == [0] * WORLD, codes
    return out, [torch.load(out / f"serve_{r}.pt", weights_only=False) for r in range(WORLD)]


def _assert_equals_twin(got, t, metrics, svc, name):
    _equal(got["state"], {k: v for k, v in t.state.items() if k != "round"}, name)
    assert got["metrics"] == metrics, name
    assert got["requeue"] == _snap(t, metrics)["requeue"], name
    assert got["round"] == t.round == ROUNDS


@pytest.mark.parametrize("name", list(CASES))
def test_group_serve_equals_the_one_device_served_run_bitwise(group_run, name):
    _, ranks = group_run
    mode, kw, cfg = CASES[name]
    t = _twin(mode, **kw)
    metrics, svc = _serve(t, dataclasses.replace(cfg, pipeline=False))
    svc.close()
    if cfg.payload == "announce":
        assert any(m["clients_dropped"] for m in metrics), "no casualties: the pin is vacuous"
    for r, got in enumerate(ranks):
        g = got[name]
        _assert_equals_twin(g, t, metrics, svc, f"{name} rank {r}")
        if mode is LOCAL:
            # rank r holds client rows [4r, 4r + 4) of the 16
            _equal(g["clients"], {k: v[4 * r:4 * r + 4] for k, v in t.client_state.items()},
                   f"{name} client rows, rank {r}")
        if cfg.payload == "sketch":
            # W / S tables a round; a pipeline's worker may have served one
            # round past the end before its stop
            want = [ROUNDS * W // WORLD] + ([(ROUNDS + 1) * W // WORLD] if cfg.pipeline else [])
            assert g["sketches"] in want, g["sketches"]
    if not cfg.pipeline:
        # a pipeline's worker serves a round or two past the end before
        # its stop, whose admissions count
        assert ranks[0][name]["counters"] == svc.queue.counters()
    assert all(got[name]["counters"] is None for got in ranks[1:])
    if cfg.payload == "sketch":
        c = svc.queue.counters()
        assert c["rejected_malformed"] >= 1, c
        # a no-show besides the corrupt frame
        assert sum(m["clients_dropped"] for m in metrics) >= 2, metrics
    if cfg.async_mode:
        assert any(m.get("stale_folded", 0) for m in metrics), "no fold: the pin is vacuous"


def test_pipelined_group_stops_together_and_continues(group_run):
    _, ranks = group_run
    t = _twin(SKETCH)
    metrics, svc = _serve(t, ANNOUNCE)
    svc.close()
    for r, got in enumerate(ranks):
        g = got["stopped"]
        assert g["workers"] == [] and g["echo"] == 100, (r, g["workers"], g["echo"])
        _assert_equals_twin(g, t, metrics, svc, f"stopped rank {r}")


def test_served_checkpoints_between_a_group_and_one_device(group_run):
    out, ranks = group_run
    t = _twin(SKETCH)
    metrics, svc = _serve(t, ANNOUNCE)
    svc.close()
    # the one-device checkpoint resumed on the group
    for r, got in enumerate(ranks):
        g = got["from_one_device"]
        _equal(g["state"], {k: v for k, v in t.state.items() if k != "round"}, f"rank {r}")
        assert g["metrics"] == metrics[2:] and g["requeue"] == _snap(t, metrics)["requeue"]
    # the group's checkpoint (rank 0's, with its serve block) resumed on
    # one device
    c = _twin(SKETCH)
    path = ckpt.latest(str(out / "group_ck"))
    assert path.endswith("round_00000002")
    ckpt.restore(path, c)
    assert c.restored_serve_meta == {"round": 2, "pending": []}
    cm, svc = _serve(c, ANNOUNCE)
    svc.close()
    assert cm == metrics[2:]
    _assert_equals_twin(_snap(c, cm), t, metrics[2:], svc, "group -> one device")


# --------------------------------------------------------------------- CLIs

CLI = ["--dataset", "cifar10", "--mode", "sketch", "--k", "100", "--num_cols", "2000",
       "--num_rows", "3", "--num_clients", "16", "--num_workers", "8", "--local_batch_size",
       "4", "--lr_scale", "0.05", "--weight_decay", "0", "--data_root", "/nonexistent",
       "--device", "cpu", "--num_rounds", "4", "--eval_every", "2", "--serve", "inproc",
       "--serve_payload", "sketch", "--serve_quorum", "8", "--serve_deadline", "30",
       "--client_update_clip", "3", "--fault_plan", "wire_corrupt@1:clients=0"]
GPT2_CLI = ["--model_size", "tiny", "--seq_len", "16", "--num_clients", "16",
            "--num_workers", "8", "--local_batch_size", "2", "--num_rounds", "2",
            "--eval_every", "2", "--eval_batch_size", "8", "--data_root", "/nonexistent",
            "--device", "cpu", "--mode", "sketch", "--k", "100", "--num_cols", "2000",
            "--serve", "inproc", "--serve_quorum", "6", "--serve_deadline", "1.0",
            "--serve_pipeline"]


def _captured(main, argv):
    """(exit code, this rank's serve: lines) of one CLI run."""
    buf, code = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, [ln for ln in buf.getvalue().splitlines() if ln.startswith("serve:")]


def _cli_ranks(out_dir):
    """Rank function: the CV CLI pipelined and preempted on rank 2, its
    resume, then the GPT-2 CLI served on the group."""
    flax_path = convert.flax_path
    _tiny_cli()
    ck = os.path.join(out_dir, "ck")
    got = {}
    got["preempted"] = _captured(cv_train.main, CLI + [
        "--serve_pipeline", "--checkpoint_dir", ck, "--fault_plan",
        "wire_corrupt@1:clients=0;host_preempt@1:host=2"])
    got["resumed"] = _captured(cv_train.main, CLI + ["--serve_pipeline", "--checkpoint_dir",
                                                     ck, "--resume"])
    convert.flax_path = flax_path  # GPT-2's own leaf order
    got["gpt2"] = _captured(gpt2_train.main, GPT2_CLI)
    torch.save(got, os.path.join(out_dir, f"cli_{distributed.rank()}.pt"))


def test_cli_group_pipelined_preempts_together_and_resumes(tiny_cv, tmp_path,  # noqa: F811
                                                           monkeypatch):
    monkeypatch.setattr(cv_train, "FederatedSession",
                        functools.partial(FederatedSession, client_shards=WORLD))
    ck_emu = str(tmp_path / "ck_emu")
    cv_train.main(CLI + ["--sync_loop", "--checkpoint_dir", ck_emu])
    codes = distributed.launch_local(_cli_ranks, WORLD, (str(tmp_path),), timeout_s=300)
    assert codes == [0] * WORLD, codes
    ranks = [torch.load(tmp_path / f"cli_{r}.pt", weights_only=False) for r in range(WORLD)]
    assert [g["preempted"][0] for g in ranks] == [EXIT_RESUMABLE] * WORLD
    assert [g["resumed"][0] for g in ranks] == [0] * WORLD
    assert sorted(os.listdir(tmp_path / "ck")) == ["round_00000002", "round_00000004"]

    def state(d):
        return torch.load(os.path.join(d, "round_00000004", "state.pt"), weights_only=True)

    _equal(state(tmp_path / "ck"), state(ck_emu))
    for r, g in enumerate(ranks):
        for run in ("preempted", "resumed", "gpt2"):
            lines = g[run][1]
            if r == 0:
                assert lines[0].startswith("serve: inproc transport") and "pipelined" in \
                    lines[0] and lines[-1].startswith("serve: final metrics"), (run, lines)
            else:
                assert lines == [], (r, run, lines)
    assert ranks[0]["gpt2"][0] == 0
