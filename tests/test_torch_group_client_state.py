"""The modes outside the reference's sharded scope on a group of ranks, and
the [num_clients, d] client state split over it (``parallel/distributed.
RowMoves``, ``engine.make_sharded_round_step``, the session's
``client_block``), on the CPU: four gloo ranks started by
``distributed.launch_local``, two launches for the whole file.

What is held, and how exactly:

- the engine: local_topk with client state (dropout, and a NaN client that
  the non-finite guard skips: its verdict is gathered from every rank),
  local_topk with virtual state and the DP clip, fedavg with the
  quarantine and localSGD, on 4 ranks, equal their one-device twin
  (``make_sharded_round_step(group=None)`` at S = 4) **bitwise** on every
  rank over 3 rounds: states, client rows and metrics; the twin is allclose
  to the unsharded round;
- the session: local_topk with local error and momentum, and fedavg, on 4
  ranks equal the one-device twin session bitwise (params, optimizer state,
  every client row, metrics), and the reference's one-device session within
  its own tolerance (rtol 1e-5, atol 1e-6); each rank holds ceil(N / 4)
  rows per key, and the bytes its row moves sent and received are
  ``mesh.client_row_bytes``'s count;
- at num_clients = 1027 the state is padded to 1028, 257 rows a rank, and
  only cohort rows below 1027 ever change (the reference's test, on 4
  ranks);
- a group checkpoint (rank 0 writes the unpadded rows) restores into a
  one-device session and a group restores a one-device checkpoint; each
  then continues equal to the other side;
- the CV CLI with client state on 4 ranks equals the single-process CLI
  within the reference's tolerance; preempted on rank 2 at round 1 it exits
  75 on every rank at round 2 and resumes to the uninterrupted run's
  checkpoint, client rows included, bitwise.

The rank functions live here at module level (``launch_local`` pickles
them by name); this module imports no JAX at its top, so the ranks do not.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from commefficient_tpu_torch.data.fed_dataset import FedDataset, shard_iid
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.federated.api import FederatedSession
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.losses import make_classification_loss
from commefficient_tpu_torch.modes.config import ModeConfig
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as meshlib
from commefficient_tpu_torch.resilience import EXIT_RESUMABLE, FaultPlan
from commefficient_tpu_torch.utils import checkpoint as ckpt
from test_torch_distributed import _cli_rank, _equal, _tiny_cli
from test_torch_runner import TINY_PATHS, TinyNet, _rows, init_tiny, tiny_cv  # noqa: F401

torch.set_num_threads(2)

WORLD, W, ROUNDS = 4, 8, 3
LRS = (0.1, 0.05, 0.2)
MESH = meshlib.ClientMesh(clients=WORLD)
LOCAL = dict(mode="local_topk", k=24, momentum=0.9, momentum_type="local", error_type="local")
FEDAVG = dict(mode="fedavg", momentum=0.9, momentum_type="local", error_type="none",
              num_local_iters=2, server_lr=0.5)
# name -> (mode, engine knobs)
ENGINE_CASES = {
    "local_topk_state": (dict(LOCAL, num_clients=16),
                         dict(client_dropout=0.25, on_nonfinite="skip")),
    "local_topk_virtual": (dict(mode="local_topk", k=24, momentum=0.9, momentum_type="virtual",
                                error_type="virtual"), dict(dp_clip=1.0, client_dropout=0.25)),
    "fedavg_quarantine": (FEDAVG, dict(client_update_clip=3.0, quarantine_window=2)),
    "localSGD": (dict(mode="localSGD", momentum=0.0, momentum_type="none", error_type="none",
                      num_local_iters=3), dict(client_dropout=0.25)),
}
SESSION_CASES = {"local_topk": LOCAL, "fedavg": FEDAVG}
MLP_PATHS = {n: (n,) for n in ("w1", "b1", "w2", "b2")}


# ------------------------------------------------------------ engine cases

def _engine_case(name):
    """(loss, cfg, layout, state0, batches, rows0) of an engine case, the
    same in every process. Round 1 masks client 2; in round 2 client 6's
    inputs are NaN (local_topk_state: the guard skips the round) or client
    5's scaled by 1e3 (fedavg_quarantine)."""
    mode, knobs = ENGINE_CASES[name]
    rng = np.random.RandomState(11)
    model = TinyNet()
    init_tiny(model, 0)
    orig, convert.flax_path = convert.flax_path, TINY_PATHS.__getitem__
    try:
        layout = convert.FlatLayout(model)
    finally:
        convert.flax_path = orig
    mcfg = ModeConfig(d=layout.d, **mode)
    L = mcfg.num_local_iters
    shape = (W, L, 4) if mcfg.uses_weight_delta else (W, 4)
    batches = [{"x": rng.standard_normal(shape + (32, 32, 3)).astype(np.float32),
                "y": rng.randint(0, 10, shape).astype(np.int32),
                "mask": np.ones(shape, np.float32), "_valid": np.ones(W, np.float32)}
               for _ in range(ROUNDS)]
    batches[1]["_valid"][2] = 0.0
    if name == "local_topk_state":
        batches[2]["x"][6] = np.nan
    if name == "fedavg_quarantine":
        batches[2]["x"][5] *= 1e3
    cfg = engine.EngineConfig(mode=mcfg, weight_decay=5e-4, seed=3, client_shards=WORLD,
                              **knobs)
    p0 = layout.flatten({k: v.detach() for k, v in model.named_parameters()})
    rows = {k: torch.from_numpy(0.01 * rng.standard_normal((W, layout.d)).astype(np.float32))
            for k in ("error", "momentum") if mcfg.needs_local_state}
    loss = make_classification_loss(model, True)
    return loss, cfg, layout, engine.init_server_state(cfg, p0, {}, layout), batches, rows


def _run_engine(name, group=None, rank=0, unsharded=False, rounds=ROUNDS):
    """The rounds of an engine case: the emulation (group None), this
    rank's shard of a group, or the unsharded round."""
    loss, cfg, layout, state, batches, rows = _engine_case(name)
    if unsharded:
        cfg = dataclasses.replace(cfg, client_shards=1)
        step = engine.make_round_step(loss, cfg, layout)
    else:
        step = engine.make_sharded_round_step(loss, cfg, layout, group)
    wl = W // WORLD
    lo, hi = (rank * wl, rank * wl + wl) if group is not None else (0, W)
    rows = {k: v[lo:hi] for k, v in rows.items()}
    metrics = []
    for b, lr in zip(batches[:rounds], LRS):
        state, rows, m = step(state, {k: torch.from_numpy(v[lo:hi]) for k, v in b.items()},
                              rows, torch.tensor(lr))
        metrics.append(m)
    return state, rows, metrics


# ----------------------------------------------------------- session cases

class _MLP(torch.nn.Module):
    def __init__(self, din, dh, dout, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.w1 = torch.nn.Parameter(torch.from_numpy(
            (0.1 * rng.standard_normal((din, dh))).astype(np.float32)))
        self.b1 = torch.nn.Parameter(torch.zeros(dh))
        self.w2 = torch.nn.Parameter(torch.from_numpy(
            (0.1 * rng.standard_normal((dh, dout))).astype(np.float32)))
        self.b2 = torch.nn.Parameter(torch.zeros(dout))


def _tloss(params, net_state, batch, masks=None):
    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    logp = torch.log_softmax(h @ params["w2"] + params["b2"], -1)
    per_ex = -torch.gather(logp, 1, batch["y"].long()[:, None])[:, 0]
    mask = batch["mask"]
    return (per_ex * mask).sum() / mask.sum().clamp_min(1.0), {
        "net_state": net_state,
        "metrics": {"loss_sum": (per_ex * mask).sum(), "count": mask.sum()}}


def _data(num_clients, din=10, dout=4, per_client=4, seed=0):
    """(x, y, client index lists): the reference test's dataset."""
    rng = np.random.RandomState(seed)
    n = num_clients * per_client
    x = rng.normal(size=(n, din)).astype(np.float32)
    w = rng.normal(size=(din, dout)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int32)
    return x, y, shard_iid(n, num_clients, rng)


def _session(num_clients, mode, seed=3, mesh=None, din=10, dh=16, dout=4, **kw):
    """The port's session of the MLP (device cpu, W = 8; ``kw`` to the
    session)."""
    if "fault_plan" in kw:
        kw["fault_plan"] = FaultPlan.parse(kw["fault_plan"])
    model = _MLP(din, dh, dout)
    orig, convert.flax_path = convert.flax_path, MLP_PATHS.__getitem__
    try:
        layout = convert.FlatLayout(model)
    finally:
        convert.flax_path = orig
    x, y, idx = _data(num_clients, din, dout)
    return FederatedSession(_tloss, _tloss, dict(model.named_parameters()), {}, layout,
                            ModeConfig(d=layout.d, num_clients=num_clients, **mode),
                            FedDataset(x, y, idx), num_workers=W, local_batch_size=4,
                            seed=seed, device="cpu", mesh=mesh, **kw)


def _jsession(num_clients, mode, seed=3, **kw):
    """The reference's one-device session of the same MLP, data and seed
    (``kw`` to the session; ``fault_plan`` as the plan's text)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from commefficient_tpu.data.fed_dataset import FedDataset as JFedDataset
    from commefficient_tpu.federated.api import FederatedSession as JSession
    from commefficient_tpu.modes.config import ModeConfig as JModeConfig
    from commefficient_tpu.resilience import FaultPlan as JFaultPlan

    def jloss(params, net_state, batch, rng):
        h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
        logp = jax.nn.log_softmax(h @ params["w2"] + params["b2"])
        per_ex = -jnp.take_along_axis(logp, batch["y"][:, None], axis=1)[:, 0]
        mask = batch["mask"]
        return (per_ex * mask).sum() / jnp.maximum(mask.sum(), 1.0), {
            "net_state": net_state,
            "metrics": {"loss_sum": (per_ex * mask).sum(), "count": mask.sum()}}

    if "fault_plan" in kw:
        kw["fault_plan"] = JFaultPlan.parse(kw["fault_plan"])
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in _MLP(10, 16, 4).named_parameters()}
    x, y, idx = _data(num_clients)
    return JSession(train_loss_fn=jloss, eval_loss_fn=jloss, params=params, net_state={},
                    mode_cfg=JModeConfig(d=ravel_pytree(params)[0].size,
                                         num_clients=num_clients, **mode),
                    train_set=JFedDataset(x, y, idx), num_workers=W, local_batch_size=4,
                    seed=seed, **kw)


def _jparams(j):
    from jax.flatten_util import ravel_pytree

    return np.asarray(ravel_pytree(j.state["params"])[0])


def _twin(num_clients, mode, seed=3):
    """The group session's one-device twin: the sharded round's emulation
    at S = 4 with the whole client state on this device (the session's
    client_shards takes only the reference's scope, so it is set here)."""
    s = _session(num_clients, mode, seed)
    s.cfg = dataclasses.replace(s.cfg, client_shards=WORLD)
    s._build_steps()
    return s


def _rounds(s, lrs):
    """Rounds one by one: (metrics, cohort ids, the row-move bytes of each)."""
    ms, ids, moved = [], [], []
    for lr in lrs:
        distributed.row_move_bytes.update(sent=0, received=0)
        prep = s.prepare_round()
        ms.append(s.commit_round(s.dispatch_round(prep, lr))[0])
        ids.append(prep.ids)
        moved.append(dict(distributed.row_move_bytes))
    return ms, ids, moved


def _snap(s):
    return {"state": s.state, "clients": s.client_state, "block": s.client_block}


def _group_ranks(out_dir):
    """Rank function of the first launch: every engine case, the sessions,
    the padding, and the checkpoints both ways."""
    distributed.initialize(force=True, device="cpu")
    rank, group = dist.get_rank(), dist.group.WORLD
    got = {"engine": {name: _run_engine(name, group, rank) for name in ENGINE_CASES}}
    for name, mode in SESSION_CASES.items():
        s = _session(16, mode, mesh=MESH)
        ms, ids, moved = _rounds(s, LRS)
        got[name] = dict(_snap(s), metrics=ms, ids=ids, moved=moved)
    pad = _session(1027, LOCAL, mesh=MESH)
    _, ids, _ = _rounds(pad, (0.1, 0.1))
    got["pad"] = dict(_snap(pad), ids=ids)
    # a group checkpoint (14 clients: padded to 16) ...
    ck_group, ck_one = os.path.join(out_dir, "ck_group"), os.path.join(out_dir, "ck_one")
    s = _session(14, LOCAL, seed=5, mesh=MESH)
    _rounds(s, (0.1, 0.1))
    got["saved"] = ckpt.save(ck_group, s)
    got["saved_block"] = _snap(s)
    # ... and a one-device one, written by rank 0
    if rank == 0:
        one = _session(14, LOCAL, seed=5)
        _rounds(one, (0.1, 0.1))
        ckpt.save(ck_one, one)
    dist.barrier()
    for key, ck in (("from_group", ck_group), ("from_one", ck_one)):
        s = _session(14, LOCAL, seed=99, mesh=MESH)
        ckpt.restore(ckpt.latest(ck), s)
        restored = _snap(s)
        ms, _, _ = _rounds(s, (0.05,))
        got[key] = dict(restored=restored, after=_snap(s), metrics=ms, round=s.round)
    torch.save(got, os.path.join(out_dir, f"group_{rank}.pt"))


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("group")
    codes = distributed.launch_local(_group_ranks, WORLD, (str(out),), timeout_s=300)
    assert codes == [0] * WORLD, codes
    return out, [torch.load(out / f"group_{r}.pt", weights_only=False) for r in range(WORLD)]


def _blocks_joined(got, key, n):
    """The group's client state, its ranks' blocks joined, cut to n rows."""
    return {k: torch.cat([g[key]["clients"][k] for g in got])[:n] for k in got[0][key]["clients"]}


# ------------------------------------------------------------------ engine

@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_group_equals_its_one_device_twin_bitwise(group_run, name):
    _, got = group_run
    state, rows, metrics = _run_engine(name)
    wl = W // WORLD
    for r in range(WORLD):
        gstate, grows, gmetrics = got[r]["engine"][name]
        _equal(gstate, state, f"{name} rank {r} state")
        _equal(gmetrics, metrics, f"{name} rank {r} metrics")
        _equal(grows, {k: v[r * wl:(r + 1) * wl] for k, v in rows.items()}, f"{name} rows")
    if name == "local_topk_state":
        # the NaN client's round is skipped on every rank: every client,
        # on every rank, keeps the rows it had before it
        assert [float(m["nonfinite_rounds"]) for m in metrics] == [0.0, 0.0, 1.0]
        _equal(rows, _run_engine(name, rounds=2)[1], "rows kept")
    if name == "fedavg_quarantine":
        # round 2's deltas (lr 0.2, the scaled client's above all) pass the
        # clip multiple of round 1's median (lr 0.05)
        assert [float(m["clients_quarantined"]) > 0 for m in metrics] == [False, False, True]


@pytest.mark.parametrize("name", ["local_topk_virtual", "fedavg_quarantine", "localSGD"])
def test_engine_twin_allclose_to_the_unsharded_round(name):
    """S = 4 associates the cohort sum otherwise than one vmap of all W:
    within 1e-5 of the unsharded round, not bitwise."""
    state, _, metrics = _run_engine(name)
    ref, _, rmetrics = _run_engine(name, unsharded=True)
    np.testing.assert_allclose(state["params"].numpy(), ref["params"].numpy(), rtol=1e-5,
                               atol=1e-6)
    for m, rm in zip(metrics, rmetrics):
        np.testing.assert_allclose(float(m["loss_sum"]), float(rm["loss_sum"]), rtol=1e-5)
        assert float(m["participants"]) == float(rm["participants"])


# ----------------------------------------------------------------- session

@pytest.mark.parametrize("name", list(SESSION_CASES))
def test_session_group_equals_the_twin_session_bitwise(group_run, name):
    _, got = group_run
    twin = _twin(16, SESSION_CASES[name])
    ms, ids, _ = _rounds(twin, LRS)
    for r in range(WORLD):
        g = got[r][name]
        _equal(g["state"], twin.state, f"{name} rank {r}")
        assert g["metrics"] == ms and all((a == b).all() for a, b in zip(g["ids"], ids))
    if name == "local_topk":
        _equal(_blocks_joined(got, name, 16), twin.client_state, "client rows")
        assert twin.client_state["error"].any() and twin.client_state["momentum"].any()
    else:
        assert all(g[name]["clients"] is None for g in got)


@pytest.mark.parametrize("name", list(SESSION_CASES))
def test_session_group_within_the_reference_tolerance(group_run, name):
    """The reference's one-device session, same seed and data: rtol 1e-5,
    atol 1e-6, the tolerance of its own mesh parity test."""
    _, got = group_run
    j = _jsession(16, SESSION_CASES[name])
    jms = [j.run_round(lr) for lr in LRS]
    g = got[0][name]
    for m, jm in zip(g["metrics"], jms):
        np.testing.assert_allclose(m["loss_sum"], jm["loss_sum"], rtol=1e-5)
    np.testing.assert_allclose(g["state"]["params"].numpy(), _jparams(j), rtol=1e-5,
                               atol=1e-6)
    if name == "local_topk":
        for k, v in _blocks_joined(got, name, 16).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(j.client_state[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_each_rank_holds_its_block_and_moves_the_counted_bytes(group_run):
    _, got = group_run
    d = got[0]["local_topk"]["state"]["params"].numel()
    for r in range(WORLD):
        g = got[r]["local_topk"]
        assert g["block"] == (4 * r, 4)
        assert {k: tuple(v.shape) for k, v in g["clients"].items()} == {"error": (4, d),
                                                                       "momentum": (4, d)}
        for ids, moved in zip(g["ids"], g["moved"]):
            want = meshlib.client_row_bytes(ids, 16, WORLD, d, 2)
            # the fetch sends what this rank owns and receives what it runs;
            # the return swaps them
            both = want["sent_per_rank"][r] + want["received_per_rank"][r]
            assert moved == {"sent": both, "received": both}, (r, ids, moved, want)
    counts = [meshlib.client_row_bytes(ids, 16, WORLD, d, 2)
              for ids in got[0]["local_topk"]["ids"]]
    assert all(c["bytes_each_way"] == sum(c["sent_per_rank"]) == sum(c["received_per_rank"])
               for c in counts)
    assert any(c["crossing"] for c in counts) and all(c["rows"] == W for c in counts)


def test_client_state_padded_to_1028_and_only_cohort_rows_change(group_run):
    """The reference's padding test on 4 ranks: 1027 clients pad to 1028,
    257 rows a rank, and the rows that changed are cohort rows below 1027."""
    _, got = group_run
    blocks = [g["pad"]["clients"]["error"] for g in got]
    assert [g["pad"]["block"] for g in got] == [(257 * r, 257) for r in range(WORLD)]
    assert all(b.shape[0] == 257 for b in blocks)
    full = torch.cat(blocks)
    touched = set(torch.nonzero(full.any(1)).flatten().tolist())
    cohorts = set(np.concatenate(got[0]["pad"]["ids"]).tolist())
    assert touched and touched <= cohorts and max(touched) < 1027
    assert not full[1027].any()


def test_checkpoint_moves_between_a_group_and_one_device(group_run):
    out, got = group_run
    # rank 0 wrote the unpadded rows once; the other ranks' saves returned None
    assert got[0]["saved"] and all(g["saved"] is None for g in got[1:])
    assert os.listdir(out / "ck_group") == ["round_00000002"]
    saved = {k: torch.cat([g["saved_block"]["clients"][k] for g in got])[:14]
             for k in got[0]["saved_block"]["clients"]}
    payload = torch.load(out / "ck_group" / "round_00000002" / ckpt.STATE_FILE,
                         weights_only=True)
    _equal(payload["client_state"], saved, "written rows")
    # the group's file restores into one device, and both continue equal
    one = _session(14, LOCAL, seed=42)
    ckpt.restore(str(out / "ck_group" / "round_00000002"), one)
    _equal(one.client_state, saved, "restored rows")
    twin = _twin(14, LOCAL, seed=42)
    ckpt.restore(str(out / "ck_group" / "round_00000002"), twin)
    tms, _, _ = _rounds(twin, (0.05,))
    oms, _, _ = _rounds(one, (0.05,))
    for r, g in enumerate(got):
        res = g["from_group"]
        assert res["round"] == 3
        pad = {k: torch.cat([v, torch.zeros(2, v.shape[1])]) for k, v in saved.items()}
        _equal(res["restored"]["clients"], {k: v[4 * r:4 * r + 4] for k, v in pad.items()},
               "group block")
        _equal(res["after"]["state"], twin.state, f"continued rank {r}")
        assert res["metrics"] == tms
    _equal({k: torch.cat([g["from_group"]["after"]["clients"][k] for g in got])[:14]
            for k in saved}, twin.client_state, "continued rows")
    np.testing.assert_allclose(one.state["params"].numpy(), twin.state["params"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(oms[0]["loss_sum"], tms[0]["loss_sum"], rtol=1e-5)
    # and back: the group restores the one-device file, rows split and padded
    one_payload = torch.load(os.path.join(ckpt.latest(str(out / "ck_one")), ckpt.STATE_FILE),
                             weights_only=True)
    joined = {k: torch.cat([g["from_one"]["restored"]["clients"][k] for g in got])
              for k in saved}
    _equal({k: v[:14] for k, v in joined.items()}, one_payload["client_state"], "split rows")
    assert not joined["error"][14:].any()
    twin_one = _twin(14, LOCAL, seed=7)
    ckpt.restore(ckpt.latest(str(out / "ck_one")), twin_one)
    tms1, _, _ = _rounds(twin_one, (0.05,))
    for g in got:
        _equal(g["from_one"]["after"]["state"], twin_one.state, "continued from one device")
        assert g["from_one"]["metrics"] == tms1


# --------------------------------------------------------------------- CLI

CLI = ["--dataset", "cifar10", "--mode", "local_topk", "--k", "200", "--num_clients", "16",
       "--num_workers", "8", "--local_batch_size", "4", "--lr_scale", "0.05",
       "--data_root", "/nonexistent", "--device", "cpu", "--num_rounds", "4",
       "--eval_every", "2", "--checkpoint_every", "2"]


def _cli_group_ranks(out_dir):
    """Rank function of the second launch: the CV CLI with client state on
    the group three times in one process: uninterrupted, preempted on rank 2
    at round 1 (every rank exits 75 at round 2), resumed."""
    _tiny_cli()
    log, ck, ck2 = (os.path.join(out_dir, n) for n in ("group.jsonl", "ck", "ck2"))
    _cli_rank(CLI + ["--log_jsonl", log, "--checkpoint_dir", ck])
    codes = {}
    try:
        _cli_rank(CLI + ["--checkpoint_dir", ck2, "--fault_plan", "host_preempt@1:host=2"])
        codes["preempted"] = 0
    except SystemExit as e:
        codes["preempted"] = e.code
    codes["saved"] = sorted(os.listdir(ck2)) if dist.get_rank() == 0 else None
    dist.barrier()
    _cli_rank(CLI + ["--checkpoint_dir", ck2, "--resume"])
    with open(os.path.join(out_dir, f"cli_{dist.get_rank()}.json"), "w") as f:
        json.dump(codes, f)


def test_cli_group_with_client_state_preempts_and_resumes(tiny_cv, tmp_path):  # noqa: F811
    from commefficient_tpu_torch import cv_train

    codes = distributed.launch_local(_cli_group_ranks, WORLD, (str(tmp_path),), timeout_s=300)
    assert codes == [0] * WORLD, codes
    one_log = str(tmp_path / "one.jsonl")
    one = cv_train.main(CLI + ["--sync_loop", "--log_jsonl", one_log])
    assert one.client_state["error"].shape[0] == 16
    group_rows, one_rows = _rows(str(tmp_path / "group.jsonl")), _rows(one_log)
    assert len(group_rows) == len(one_rows) == 2
    for g, o in zip(group_rows, one_rows):
        assert g.keys() == o.keys()
        for k in g:
            np.testing.assert_allclose(g[k], o[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for r in range(WORLD):
        c = json.loads((tmp_path / f"cli_{r}.json").read_text())
        assert c["preempted"] == EXIT_RESUMABLE, c
    assert json.loads((tmp_path / "cli_0.json").read_text())["saved"] == ["round_00000002"]

    def state(ck):
        return torch.load(tmp_path / ck / "round_00000004" / ckpt.STATE_FILE, weights_only=True)

    _equal(state("ck2"), state("ck"), "resumed")
    assert state("ck")["client_state"]["error"].shape[0] == 16
