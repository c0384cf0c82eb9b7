"""The port's sharded round on a group of ranks (``parallel/distributed.py``,
``engine.make_sharded_round_step(group=...)``), on the CPU: four processes
in a gloo group, started by ``distributed.launch_local`` with the
environment torchrun would give them.

What is held, and how exactly:

- four ranks equal the port's own emulation at S = 4 (one process, a loop
  over the shards) **bitwise**, over 3 rounds: params, Vvelocity, Verror
  and every metric, on every rank, in the reference's three mode cases
  (sketch with dropout and the non-finite guard, uncompressed with the DP
  clip and noise, true_topk at client_chunk 2), a quarantined sketch case
  and GPT-2 at two layers with its per-slot dropout (each client's masks
  come from its global cohort slot), and the sketch and GPT-2 cases again
  under ``sketch_path="layerwise"``, whose emulation equals the ravel
  emulation bitwise;
- the CLI on four ranks writes rows byte-equal (except ``time_s``) to the
  single-process CLI running the emulation, with equal ledger fingerprints
  on every rank every round; rank 0 alone writes the rows and the
  checkpoints; ``dist_init:times=2`` is recovered by the join's retries;
- ``host_preempt@1:host=2`` signals rank 2 only, and every rank exits 75
  at the same round, with one checkpoint (rank 0's); ``--resume`` from it
  ends bitwise on the uninterrupted run's state;
- ``all_hosts_max`` is the max over the ranks; local_topk with client
  state, fedavg and a trimmed merge run on the group and equal their
  one-device twins bitwise over 2 rounds, client rows included (the
  emulation at S = 4; tests/test_torch_group_client_state.py and
  tests/test_torch_group_tables.py hold the rest); ``--serve`` runs on a
  group (rank 0's service, the others' followers, equal params: the
  bitwise pins are tests/test_torch_group_serve.py's); ``dist_init@1`` is
  refused at launch.

The rank functions live here at module level (``launch_local`` pickles
them by name) and import no JAX."""

import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.data.cifar import load_cifar_fed
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.federated.api import FederatedSession
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_classification_loss, make_lm_loss
from commefficient_tpu_torch.modes.config import ModeConfig
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel.mesh import ClientMesh
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE, FaultPlan
from commefficient_tpu_torch.serve import service_from_args
from commefficient_tpu_torch.utils.config import make_parser
from test_torch_runner import TINY_PATHS, TinyNet, _rows, init_tiny, tiny_cv  # noqa: F401

torch.set_num_threads(2)

WORLD, W, ROUNDS = 4, 8, 3
LRS = (0.1, 0.05, 0.2)
SKETCH = dict(mode="sketch", k=16, num_rows=3, num_cols=1024, momentum=0.9,
              momentum_type="virtual", error_type="virtual")
# name -> (mode, engine knobs)
CASES = {
    "sketch": (SKETCH, dict(client_dropout=0.25, on_nonfinite="skip")),
    "uncompressed_dp": (dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                             error_type="none"),
                        dict(dp_clip=1.0, dp_noise=0.5, client_dropout=0.3)),
    "true_topk_chunked": (dict(mode="true_topk", k=24, momentum=0.9, momentum_type="virtual",
                               error_type="virtual"), dict(client_chunk=2)),
    "sketch_quarantine": (SKETCH, dict(client_update_clip=3.0, quarantine_scope="layer",
                                       quarantine_window=2)),
    "gpt2_dropout": (dict(SKETCH, k=64, num_cols=4096), dict(client_dropout=0.25)),
    # the layerwise sketch path: each shard's partial table folded leaf by leaf
    "sketch_layerwise": (SKETCH, dict(client_dropout=0.25, on_nonfinite="skip",
                                      sketch_path="layerwise")),
    "gpt2_dropout_layerwise": (dict(SKETCH, k=64, num_cols=4096),
                               dict(client_dropout=0.25, sketch_path="layerwise")),
}
T, V = 16, 261


def _case(name):
    """(loss, cfg, layout, state0, batches) of a case: the same in every
    process, from fixed seeds. Round 1 masks client 2 (validity 0); in the
    quarantine case round 2 scales client 5's inputs by 1e3."""
    mode, knobs = CASES[name]
    rng = np.random.RandomState(11)
    if name.startswith("gpt2"):
        import dataclasses

        model = tgpt2.GPT2LMHead(dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T,
                                                     dropout=0.1))
        tgpt2.init_weights(model, 0)
        loss = make_lm_loss(model, train=True)
        layout = convert.FlatLayout(model)
        batches = []
        for _ in range(ROUNDS):
            ids = rng.randint(0, V, (W, 2, T)).astype(np.int32)
            labels = np.where(rng.rand(W, 2, T) < 0.3, -100, ids).astype(np.int32)
            batches.append({"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                            "labels": labels})
    else:
        model = TinyNet()
        init_tiny(model, 0)
        loss = make_classification_loss(model, True)
        orig, convert.flax_path = convert.flax_path, TINY_PATHS.__getitem__
        try:
            layout = convert.FlatLayout(model)
        finally:
            convert.flax_path = orig
        batches = [{"x": rng.standard_normal((W, 4, 32, 32, 3)).astype(np.float32),
                    "y": rng.randint(0, 10, (W, 4)).astype(np.int32),
                    "mask": np.ones((W, 4), np.float32)} for _ in range(ROUNDS)]
    for i, b in enumerate(batches):
        b["_valid"] = np.ones(W, np.float32)
        if i == 1:
            b["_valid"][2] = 0.0
        if i == 2 and name == "sketch_quarantine":
            b["x"][5] *= 1e3
    cfg = engine.EngineConfig(mode=ModeConfig(d=layout.d, **mode), weight_decay=5e-4, seed=3,
                              client_shards=WORLD, **knobs)
    p0 = layout.flatten({k: v.detach() for k, v in model.named_parameters()})
    return loss, cfg, layout, engine.init_server_state(cfg, p0, {}, layout), batches


def _run_case(name, group=None, rank=0):
    """3 rounds of a case: the emulation (group None, whole batches) or
    this rank's shard of a group (its slice of each batch)."""
    loss, cfg, layout, state, batches = _case(name)
    step = engine.make_sharded_round_step(loss, cfg, layout, group)
    wl = W // WORLD
    lo, hi = (rank * wl, rank * wl + wl) if group is not None else (0, W)
    metrics = []
    for b, lr in zip(batches, LRS):
        state, _, m = step(state, {k: torch.from_numpy(v[lo:hi]) for k, v in b.items()}, {},
                           torch.tensor(lr))
        metrics.append(m)
    return state, metrics


# the sessions beyond the sharded round's linear scope: name -> (mode, knobs)
GROUP_SESSIONS = {
    "local_topk": (dict(mode="local_topk", k=4, momentum=0.9, momentum_type="local",
                        error_type="local", num_clients=16), {}),
    "fedavg": (dict(mode="fedavg", momentum=0.0, momentum_type="none", error_type="none",
                    num_local_iters=2), {}),
    "trimmed": (SKETCH, dict(merge_policy="trimmed", merge_trim=1)),
}


def _group_session_run(name, mesh=None):
    """2 rounds of a GROUP_SESSIONS case: on the group (``mesh``), or its
    one-device twin, the emulation at S = 4 (the session's client_shards
    takes only the reference's scope, so local_topk's and fedavg's is set
    on the built session)."""
    import dataclasses

    mode, kw = GROUP_SESSIONS[name]
    if mesh is not None:
        s = _tiny_session(mode, mesh=mesh, **kw)
    elif name == "trimmed":
        s = _tiny_session(mode, client_shards=WORLD, **kw)
    else:
        s = _tiny_session(mode, **kw)
        s.cfg = dataclasses.replace(s.cfg, client_shards=WORLD)
        s._build_steps()
    ms = [s.run_round(lr) for lr in LRS[:2]]
    return {"state": s.state, "clients": s.client_state, "metrics": ms}


def _engine_ranks(out_dir):
    """Rank function: every case on the group, the sessions beyond the
    linear scope, then the agreement and two served rounds; each rank saves
    what it got."""
    distributed.initialize(force=True, device="cpu")
    rank = dist.get_rank()
    got = {name: _run_case(name, dist.group.WORLD, rank) for name in CASES}
    got["sessions"] = {name: _group_session_run(name, ClientMesh(clients=WORLD))
                       for name in GROUP_SESSIONS}
    torch.save(got, os.path.join(out_dir, f"engine_{rank}.pt"))
    extra = {"max_rank": distributed.all_hosts_max(rank), "max_zero": distributed.all_hosts_max(0)}
    # --serve on the group: the mesh is not refused, rank 0 builds the
    # service and the others a follower, and two served rounds run
    args = make_parser().parse_args(["--serve", "inproc", "--serve_quorum", "6",
                                     "--num_clients", "16"])
    s = _tiny_session(SKETCH, mesh=distributed.cli_mesh(args))
    svc = service_from_args(args, s)
    src = svc.source()
    for lr in LRS[:2]:
        s.commit_round(s.dispatch_round(src.next(), lr))
    src.stop()
    svc.close()
    extra["serve"] = {"kind": type(svc).__name__, "round": s.round,
                      "params": s.state["params"].tolist()}
    with open(os.path.join(out_dir, f"extra_{rank}.json"), "w") as f:
        json.dump(extra, f)


def _tiny_session(mode, **kw):
    orig, convert.flax_path = convert.flax_path, TINY_PATHS.__getitem__
    try:
        model = TinyNet()
        init_tiny(model, 0)
        train, _, _ = load_cifar_fed("cifar10", 16, False, "/nonexistent", 0, synthetic_train=64,
                                     synthetic_test=8)
        layout = convert.FlatLayout(model)
        return FederatedSession(make_classification_loss(model, True),
                                make_classification_loss(model, False),
                                dict(model.named_parameters()), {}, layout,
                                ModeConfig(d=layout.d, **mode), train, num_workers=8,
                                local_batch_size=2, device="cpu", **kw)
    finally:
        convert.flax_path = orig


def _tiny_cli():
    """The CLI's model and data swapped for the tiny twins, as the
    ``tiny_cv`` fixture swaps them."""
    orig = cv_train.load_cifar_fed

    def tiny(*a, **kw):
        kw.update(synthetic_train=64, synthetic_test=32)
        return orig(*a, **kw)

    cv_train.load_cifar_fed = tiny
    cv_train.ResNet9 = TinyNet
    cv_train.init_weights = init_tiny
    convert.flax_path = TINY_PATHS.__getitem__


def _cli_rank(argv):
    """Rank function: the CV CLI with the tiny twins, joining from the
    environment."""
    _tiny_cli()
    cv_train.main(list(argv))


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _launch(fn, *args):
    return distributed.launch_local(fn, WORLD, args, timeout_s=240)


# ------------------------------------------------------------------ engine

def test_four_gloo_ranks_equal_the_emulation_bitwise(tmp_path):
    codes = _launch(_engine_ranks, str(tmp_path))
    assert codes == [0] * WORLD, codes
    for name in CASES:
        want = _run_case(name)
        for rank in range(WORLD):
            got = torch.load(tmp_path / f"engine_{rank}.pt", weights_only=False)[name]
            _equal(got, want, f"{name} rank {rank}")
        if name == "sketch_quarantine":
            assert [float(m["clients_quarantined"]) for m in want[1]] == [0.0, 0.0, 1.0]
        if "dropout" in name or name in ("sketch", "sketch_layerwise"):
            assert float(want[1][0]["participants"]) < W  # the mask dropped someone
        if name.endswith("_layerwise"):
            # the layerwise emulation is the ravel emulation, bitwise
            _equal(want, _run_case(name[:-len("_layerwise")]), name)
    for name in GROUP_SESSIONS:
        want = _group_session_run(name)
        for rank in range(WORLD):
            got = torch.load(tmp_path / f"engine_{rank}.pt", weights_only=False)["sessions"][name]
            _equal(got["state"], want["state"], f"{name} rank {rank}")
            assert got["metrics"] == want["metrics"], (name, rank)
            if name == "local_topk":
                # rank r holds client rows [4r, 4r + 4) of the 16
                _equal(got["clients"], {k: v[4 * rank:4 * rank + 4]
                                        for k, v in want["clients"].items()}, "client rows")
            else:
                assert got["clients"] is None and want["clients"] is None
    for rank in range(WORLD):
        extra = json.loads((tmp_path / f"extra_{rank}.json").read_text())
        assert (extra["max_rank"], extra["max_zero"]) == (WORLD - 1, 0)
        served = json.loads((tmp_path / "extra_0.json").read_text())["serve"]
        assert extra["serve"]["kind"] == ("AggregationService" if rank == 0
                                          else "ServeFollower")
        assert extra["serve"]["round"] == 2 and extra["serve"]["params"] == served["params"]


def test_single_process_agreement_touches_no_group():
    """One process: ``all_hosts_max`` returns its value, the preemption
    agreement its local flag, and nothing joins a group."""
    from commefficient_tpu_torch.resilience import preemption

    assert not distributed.is_joined() and distributed.world_size() == 1
    assert distributed.all_hosts_max(5) == 5
    assert preemption.coordinated(True) and not preemption.coordinated(False)
    assert not distributed.initialize(fault_plan=FaultPlan.parse("dist_init:times=9"))
    assert not distributed.is_joined()


def test_dist_init_schedule_refused_at_launch():
    with pytest.raises(ValueError, match="'dist_init' fires at bootstrap and cannot take an "
                                         "@round schedule"):
        FaultPlan.parse("dist_init@1")
    plan = FaultPlan.parse("host_preempt@3:host=4")
    with pytest.raises(ValueError, match="host_preempt:host=4 can never fire - this job has 4"):
        plan.validate_rounds(10, world_size=4)
    with pytest.raises(ValueError, match="host_preempt@12 can never fire"):
        FaultPlan.parse("host_preempt@12:host=0").validate_rounds(10, world_size=4)
    FaultPlan.parse("host_preempt@3:host=3").validate_rounds(10, world_size=4)


def test_forced_join_without_a_cluster_raises():
    with pytest.raises(ValueError, match="cannot join a process group"):
        distributed.initialize(force=True, device="cpu")
    assert not distributed.is_joined()


# ------------------------------------------------------------------ the CLI

COMMON = ["--dataset", "cifar10", "--mode", "sketch", "--k", "100", "--num_cols", "2000",
          "--num_rows", "3", "--num_clients", "16", "--num_workers", "8",
          "--local_batch_size", "4", "--lr_scale", "0.05", "--weight_decay", "0",
          "--data_root", "/nonexistent", "--device", "cpu", "--num_rounds", "4",
          "--eval_every", "2", "--client_dropout", "0.25", "--checkpoint_every", "2"]


def _state(ck, rnd):
    return torch.load(os.path.join(ck, f"round_{rnd:08d}", "state.pt"), weights_only=True)


def test_cli_on_four_ranks_equals_the_emulation_preempts_together_and_resumes(
        tiny_cv, tmp_path, monkeypatch):  # noqa: F811
    # the emulation: the single-process CLI with the session at S = 4
    monkeypatch.setattr(cv_train, "FederatedSession",
                        functools.partial(FederatedSession, client_shards=WORLD))
    emu_log, ck_emu = str(tmp_path / "emu.jsonl"), str(tmp_path / "ck_emu")
    emu = cv_train.main(COMMON + ["--sync_loop", "--log_jsonl", emu_log,
                                  "--checkpoint_dir", ck_emu])
    assert emu.cfg.client_shards == WORLD

    # four ranks, async loop, the join failing twice first
    log, ledger, ck = str(tmp_path / "mesh.jsonl"), str(tmp_path / "ledger"), str(tmp_path / "ck")
    codes = _launch(_cli_rank, COMMON + ["--log_jsonl", log, "--ledger", ledger,
                                         "--checkpoint_dir", ck, "--max_retries", "3",
                                         "--fault_plan", "dist_init:times=2"])
    assert codes == [0] * WORLD, codes
    assert _rows(log) == _rows(emu_log)
    assert sorted(os.listdir(ck)) == sorted(os.listdir(ck_emu)) == ["round_00000002",
                                                                     "round_00000004"]
    _equal(_state(ck, 4), _state(ck_emu, 4))
    prints = [[json.loads(ln)["fingerprint"] for ln in open(p) if '"round"' in ln]
              for p in [ledger] + [f"{ledger}.rank{r}" for r in range(1, WORLD)]]
    assert len(prints[0]) == 4 and all(p == prints[0] for p in prints)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("mesh.jsonl.")]

    # host_preempt@1 signals rank 2 alone: all four exit 75 at round 2
    ck2 = str(tmp_path / "ck2")
    codes = _launch(_cli_rank, COMMON + ["--checkpoint_dir", ck2, "--fault_plan",
                                         "host_preempt@1:host=2"])
    assert codes == [EXIT_RESUMABLE] * WORLD, codes
    assert os.listdir(ck2) == ["round_00000002"]
    _equal(_state(ck2, 2), _state(ck, 2))
    # the resume from rank 0's checkpoint lands on the uninterrupted run
    codes = _launch(_cli_rank, COMMON + ["--checkpoint_dir", ck2, "--resume"])
    assert codes == [0] * WORLD, codes
    _equal(_state(ck2, 4), _state(ck, 4))

