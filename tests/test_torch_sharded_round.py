"""The port's sharded round (``engine.make_sharded_round_step``, one
device: the emulation, a loop over the S shards) against the JAX package's
``make_sharded_round_step(loss, cfg, mesh=None)`` at the same S, on the
reference's ``MODE_CASES`` (tests/test_sharded_round.py: sketch with
dropout and the non-finite guard, uncompressed with the DP clip and noise,
true_topk at client_chunk 2) and a quarantined sketch case; GPT-2 at two
layers; the merge; the session's routing and its cohort rules.

Tolerances, as in tests/test_torch_round.py and test_torch_quarantine.py.
The participation mask and the DP noise are given to both packages (the
reference draws them from threefry keys, which torch cannot reproduce):
with them, new params within atol 1e-5 (a released top-k set may differ
at a near-tie: at most 2 coordinates), Vvelocity and Verror within atol
1e-5, metric sums rtol 1e-5, the participants and quarantined counts
exact, the running median rtol 1e-5. The ordered merge of the partial
tables: bitwise. The emulation against the port's own unsharded round:
allclose (other S sum in another order), atol 1e-5. Inside the port: a
block of rounds equals those rounds one by one, bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.data.fed_dataset import FedDataset as JFedDataset
from commefficient_tpu.data.fed_dataset import shard_iid as jshard_iid
from commefficient_tpu.data.personachat import load_personachat_fed as jload
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.federated.api import FederatedSession as JSession
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.models.losses import make_lm_loss as jlm
from commefficient_tpu.modes import modes as jmodes
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch.data.fed_dataset import FedDataset as TFedDataset
from commefficient_tpu_torch.data.fed_dataset import shard_iid as tshard_iid
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.federated.api import FederatedSession as TSession
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from commefficient_tpu_torch.models.losses import make_lm_loss as tlm
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.parallel.mesh import ClientMesh
from commefficient_tpu_torch.sketch import layerwise as tlayerwise
from test_torch_cohort_faults import _image_batch, _tiny_pair
from test_torch_loop_parity import TINY_PATHS
from test_torch_serve import DOUT, _data, _jquad, _Quad, _tquad

torch.set_num_threads(2)

ATOL, LR, WD, W = 1e-5, 0.1, 5e-4, 8
SKETCH_KW = dict(mode="sketch", k=16, num_rows=3, num_cols=1024, hash_family="rotation",
                 momentum=0.9, momentum_type="virtual", error_type="virtual")
MODE_CASES = [
    ("sketch", SKETCH_KW, dict(client_dropout=0.25, on_nonfinite="skip")),
    ("uncompressed_dp", dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                             error_type="none"),
     dict(dp_clip=1.0, dp_noise=0.5, client_dropout=0.3)),
    ("true_topk_chunked", dict(mode="true_topk", k=24, momentum=0.9, momentum_type="virtual",
                               error_type="virtual"), dict(client_chunk=2)),
    ("sketch_quarantine", SKETCH_KW, dict(client_update_clip=3.0, quarantine_scope="layer")),
]
# the survivors of the participation mask given to both packages
MASK = np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float32)


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)
    return _tiny_pair()


def _given_streams(monkeypatch, d):
    """The participation mask and the DP noise, given to both packages:
    the reference's threefry draws and the port's generators replaced by
    the same numpy values (each package's own std)."""
    noise = np.random.RandomState(7).standard_normal(d).astype(np.float32)

    def jmask(rng, n, p):
        return jnp.asarray(MASK[:n]) if p > 0 else jnp.ones(n, jnp.float32)

    def tmask(seed, rnd, n, p, device="cpu"):
        return torch.from_numpy(MASK[:n].copy()) if p > 0 else torch.ones(n)

    def jnoise(cfg, agg, participants, rng):
        sens = cfg.dp_clip / jnp.maximum(participants, 1.0)
        std = jnp.float32(cfg.dp_noise) * sens * (participants > 0)
        return {k: v + std * jnp.asarray(noise) for k, v in agg.items()}

    def tnoise(cfg, agg, participants, rnd):
        sens = cfg.dp_clip / participants.clamp_min(1.0)
        std = cfg.dp_noise * sens * (participants > 0).to(torch.float32)
        return {k: v + std * torch.from_numpy(noise) for k, v in agg.items()}

    monkeypatch.setattr(jengine, "participation_mask", jmask)
    monkeypatch.setattr(tengine, "participation_mask", tmask)
    monkeypatch.setattr(jengine, "_dp_noise_agg", jnoise)
    monkeypatch.setattr(tengine, "_dp_noise_agg", tnoise)


def _assert_round_close(tnew, tm, jnew, jm, p0, mode_kw, quarantine=False):
    """The port's round against the reference's, at the stated tolerances."""
    for k in ("loss_sum", "count", "correct"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["participants"]) == float(jm["participants"])
    if "nonfinite_rounds" in jm:
        assert float(tm["nonfinite_rounds"]) == float(jm["nonfinite_rounds"])
    if quarantine:
        assert float(tm["clients_quarantined"]) == float(jm["clients_quarantined"])
        np.testing.assert_allclose(float(tm["quarantine_median"]),
                                   float(jm["quarantine_median"]), rtol=1e-5)
    jp, tp = np.asarray(ravel_pytree(jnew["params"])[0]), tnew["params"].numpy()
    if mode_kw["mode"] == "uncompressed":
        np.testing.assert_allclose(tp, jp, rtol=0, atol=ATOL)
    else:
        j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
        assert len(t_set) == mode_kw["k"] and len(j_set ^ t_set) <= 2, j_set ^ t_set
        same = np.array(sorted(j_set & t_set))
        np.testing.assert_allclose(tp[same], jp[same], rtol=0, atol=ATOL)
    for k in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(tnew["mode_state"][k].numpy(),
                                   np.asarray(jnew["mode_state"][k]), rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name, mode_kw, eng_kw", MODE_CASES, ids=[c[0] for c in MODE_CASES])
def test_emulation_matches_the_reference_sharded_round(monkeypatch, tiny, name, mode_kw,
                                                        eng_kw, shards):
    """One sharded round at S shards through both engines, from the same
    params, server state (a random Vvelocity/Verror; with the quarantine,
    a running median from the cohort's own norms, so the screen is armed)
    and batch, with the mask and noise given. In the quarantine case
    client 5's inputs are scaled by 1e3 and it must be quarantined."""
    fmodel, params, tmodel = tiny
    layout = convert.FlatLayout(tmodel)
    d = layout.d
    _given_streams(monkeypatch, d)
    batch = _image_batch(W)
    batch["_valid"] = np.ones(W, np.float32)
    quarantine = eng_kw.get("client_update_clip", 0) > 0
    if quarantine:
        batch["x"][5] *= 1e3
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                client_shards=shards, **eng_kw)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=d, **mode_kw), weight_decay=WD,
                                client_shards=shards, **eng_kw)
    jstate = jengine.init_server_state(jcfg, params, {})
    tstate = tengine.init_server_state(tcfg, layout.flatten(
        {k: v.detach() for k, v in tmodel.named_parameters()}), {}, layout)
    rng = np.random.RandomState(3)
    for k, v in tstate["mode_state"].items():
        x = (1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
        if mode_kw["mode"] == "uncompressed" and k == "Verror":
            x[:] = 0
        tstate["mode_state"][k] = torch.from_numpy(x)
        jstate["mode_state"][k] = jnp.asarray(x)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if quarantine:
        # the running medians of the clean clients' own norms
        u, _, _ = tengine.make_client_updates(tloss(tmodel, True), tcfg, layout)(
            tstate, {k: v for k, v in tb.items() if k != "_valid"}, None, range(W))
        clean = [w for w in range(W) if w != 5]
        med = torch.median(tengine._client_norms(u)[clean]).reshape(())
        lmed = torch.median(tengine._client_layer_norms(
            u, tlayerwise.leaf_segments(layout))[clean], dim=0).values
        tstate["quarantine"] = {"median": med, "layer_median": lmed}
        jstate["quarantine"] = {"median": jnp.asarray(med.numpy()),
                                "layer_median": jnp.asarray(lmed.numpy())}
    jstep = jax.jit(jengine.make_sharded_round_step(jloss(fmodel, True), jcfg))
    jnew, _, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(LR),
                        jax.random.PRNGKey(0))
    tstep = tengine.make_sharded_round_step(tloss(tmodel, True), tcfg, layout)
    tnew, _, tm = tstep(tstate, tb, {}, LR)
    if quarantine:
        assert float(tm["clients_quarantined"]) == 1.0
    _assert_round_close(tnew, tm, jnew, jm, layout.flatten(
        {k: v.detach() for k, v in tmodel.named_parameters()}).numpy(), mode_kw, quarantine)


def test_gpt2_two_layers_emulation_matches_the_reference():
    """GPT-2 at 2 layers x n_embd 64 (vocabulary 261, T = 32, dropout 0),
    4 clients over S = 2 shards, one FetchSGD round through both engines."""
    T, V, B, K = 32, 261, 2, 200
    jcfg_m = dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T)
    tcfg_m = dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T)
    assert jcfg_m.n_layer == tcfg_m.n_layer == 2
    jmodel = jgpt2.GPT2LMHead(jcfg_m)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, T), jnp.int32), train=False)["params"])
    tmodel = tgpt2.GPT2LMHead(tcfg_m)
    tparams, _ = convert.params_from_flax(tmodel, params, {})
    train, _, _ = jload("/nonexistent", 40, T, 0)
    rng = np.random.RandomState(1)
    batch = train.client_batch(rng, train.sample_clients(rng, 4), B)
    batch["_valid"] = np.ones(4, np.float32)
    mode_kw = dict(SKETCH_KW, k=K, num_cols=4096, num_rows=5)
    d = ravel_pytree(params)[0].size
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                client_shards=2, on_nonfinite="skip")
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=d, **mode_kw), weight_decay=WD,
                                client_shards=2, on_nonfinite="skip")
    layout = convert.FlatLayout(tmodel)
    jnew, _, jm = jax.jit(jengine.make_sharded_round_step(jlm(jmodel, True), jcfg))(
        jengine.init_server_state(jcfg, params, {}), jax.tree.map(jnp.asarray, batch), {},
        jnp.float32(LR), jax.random.PRNGKey(0))
    p0 = layout.flatten(tparams)
    tnew, _, tm = tengine.make_sharded_round_step(tlm(tmodel, True), tcfg, layout)(
        tengine.init_server_state(tcfg, p0, {}), {k: torch.from_numpy(v) for k, v in
                                                   batch.items()}, {}, LR)
    _assert_round_close(tnew, tm, jnew, jm, p0.numpy(), mode_kw)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_ordered_merge_of_partial_tables_is_bitwise_the_reference(shards):
    """The tail's merge of the [S, r, c] partial tables: the port's ordered
    sum (table 0 first) equals the reference's, bit for bit. The dense
    partial wires are summed over the shard axis by each framework's own
    reduction, which XLA associates in another order from S = 8 on: within
    rtol 1e-6 there."""
    rng = np.random.RandomState(shards)
    tables = (rng.standard_normal((shards, 3, 1024)) * 10.0 ** rng.randint(-3, 3, (shards, 1, 1))
              ).astype(np.float32)
    t = tmodes.merge_partial_wires(TModeConfig(d=98_666, **SKETCH_KW),
                                   {"table": torch.from_numpy(tables)})["table"]
    j = jmodes.merge_partial_wires(JModeConfig(d=98_666, **SKETCH_KW),
                                   {"table": jnp.asarray(tables)})["table"]
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    dense = rng.standard_normal((shards, 98_666)).astype(np.float32)
    kw = dict(mode="true_topk", k=24)
    t = tmodes.merge_partial_wires(TModeConfig(d=98_666, **kw),
                                   {"dense": torch.from_numpy(dense)})["dense"]
    j = jmodes.merge_partial_wires(JModeConfig(d=98_666, **kw), {"dense": jnp.asarray(dense)})
    np.testing.assert_allclose(t.numpy(), np.asarray(j["dense"]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name, mode_kw, eng_kw", MODE_CASES[:2], ids=[c[0] for c in
                                                                         MODE_CASES[:2]])
def test_emulation_allclose_to_the_plain_round(tiny, name, mode_kw, eng_kw, shards):
    """Across shard counts the round changes only by the order of its sums:
    the emulation at S shards stays within atol 1e-5 of the unsharded
    round (same draws: both are functions of the seed and the round)."""
    _, _, tmodel = tiny
    layout = convert.FlatLayout(tmodel)
    cfg = tengine.EngineConfig(mode=TModeConfig(d=layout.d, **mode_kw), weight_decay=WD,
                               seed=5, **eng_kw)
    p0 = layout.flatten({k: v.detach() for k, v in tmodel.named_parameters()})
    tb = {k: torch.from_numpy(v) for k, v in _image_batch(W).items()}
    plain, _, pm = tengine.make_round_step(tloss(tmodel, True), cfg, layout)(
        tengine.init_server_state(cfg, p0, {}), tb, {}, LR)
    scfg = dataclasses.replace(cfg, client_shards=shards)
    sharded, _, sm = tengine.make_sharded_round_step(tloss(tmodel, True), scfg, layout)(
        tengine.init_server_state(scfg, p0, {}), tb, {}, LR)
    assert float(sm["participants"]) == float(pm["participants"])
    np.testing.assert_allclose(float(sm["loss_sum"]), float(pm["loss_sum"]), rtol=1e-5)
    if mode_kw["mode"] == "uncompressed":
        np.testing.assert_allclose(sharded["params"].numpy(), plain["params"].numpy(),
                                   rtol=0, atol=ATOL)
    else:
        a, b = sharded["params"] != p0, plain["params"] != p0
        assert int((a ^ b).sum()) <= 2
        np.testing.assert_allclose(sharded["params"][a & b].numpy(),
                                   plain["params"][a & b].numpy(), rtol=0, atol=ATOL)


def test_sharded_block_of_rounds_equals_rounds_one_by_one(tiny):
    """``make_multi_round_step`` over the sharded step: a block of 3 rounds
    is bitwise the 3 rounds one by one (the reference's
    test_sharded_multi_round_block_matches_sequential)."""
    _, _, tmodel = tiny
    layout = convert.FlatLayout(tmodel)
    cfg = tengine.EngineConfig(mode=TModeConfig(d=layout.d, **SKETCH_KW), weight_decay=WD,
                               client_shards=4, client_dropout=0.25, seed=3)
    p0 = layout.flatten({k: v.detach() for k, v in tmodel.named_parameters()})
    step = tengine.make_sharded_round_step(tloss(tmodel, True), cfg, layout)
    multi = tengine.make_multi_round_step(tloss(tmodel, True), cfg, layout, step)
    batches = [_image_batch(W, seed=s) for s in range(3)]
    lrs = torch.tensor([0.1, 0.05, 0.2])
    s = tengine.init_server_state(cfg, p0, {})
    ms = []
    for b, lr in zip(batches, lrs):
        s, _, m = step(s, {k: torch.from_numpy(v) for k, v in b.items()}, {}, lr)
        ms.append(m)
    blk, bm = multi(tengine.init_server_state(cfg, p0, {}),
                    {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]},
                    lrs)
    assert torch.equal(blk["params"], s["params"]) and blk["round"] == 3
    for k in s["mode_state"]:
        assert torch.equal(blk["mode_state"][k], s["mode_state"][k])
    for k in ms[0]:
        assert torch.equal(bm[k], torch.stack([m[k] for m in ms])), k


@pytest.mark.parametrize("mode_kw", [
    dict(mode="local_topk", k=4, momentum=0.9, momentum_type="local", error_type="local",
         num_clients=12),
    dict(mode="fedavg", momentum=0.0, momentum_type="none", error_type="none",
         num_local_iters=2)], ids=["local_topk", "fedavg"])
def test_sharded_scope_refused_as_the_reference(quad, mode_kw):
    """A robust policy raises in both engines. The reference's engine
    refuses the out-of-scope modes, which it runs over a mesh by GSPMD; the
    port's builds them, as the one-device twin of its group round
    (tests/test_torch_group_client_state.py), and both sessions refuse them
    at client_shards > 1
    (``test_session_out_of_scope_client_shards_raises_as_the_reference``)."""
    with pytest.raises(ValueError, match="sharded round supports linear grad modes"):
        jengine.make_sharded_round_step(_tquad, jengine.EngineConfig(
            mode=JModeConfig(d=21, **mode_kw), client_shards=2))
    layout = convert.FlatLayout(_Quad(_data()[2]))
    assert layout.d == 21 and callable(tengine.make_sharded_round_step(
        _tquad, tengine.EngineConfig(mode=TModeConfig(d=21, **mode_kw), client_shards=2),
        layout))
    cfgs = [(tengine, TModeConfig), (jengine, JModeConfig)]
    for eng, MC in cfgs:
        with pytest.raises(ValueError, match="needs the per-client-table round"):
            eng.make_sharded_round_step(_tquad, eng.EngineConfig(
                mode=MC(d=21, **SKETCH_KW), client_shards=2, merge_policy="median"),
                *([None] if eng is tengine else []))


# ------------------------------------------------- the session's cohort rules

@pytest.fixture()
def quad(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", {"w": ("w",), "b": ("b",)}.__getitem__)


SESSION_SKETCH = dict(mode="sketch", k=4, num_rows=3, num_cols=8, momentum=0.9,
                      momentum_type="virtual", error_type="virtual")


def _tsession(num_clients=12, workers=8, mode=SESSION_SKETCH, **kw):
    """The port's session of the quadratic model."""
    x, y, w0 = _data()
    tmodel = _Quad(w0)
    layout = convert.FlatLayout(tmodel)
    return TSession(train_loss_fn=_tquad, eval_loss_fn=_tquad,
                    params=dict(tmodel.named_parameters()), net_state={}, layout=layout,
                    mode_cfg=TModeConfig(d=layout.d, **mode),
                    train_set=TFedDataset(x, y, tshard_iid(len(x), num_clients,
                                                           np.random.RandomState(1))),
                    num_workers=workers, local_batch_size=4, seed=0, device="cpu", **kw)


def _jsession(num_clients=12, workers=8, mode=SESSION_SKETCH, **kw):
    """The reference's session on the same data and weights."""
    x, y, w0 = _data()
    params = {"w": jnp.asarray(w0), "b": jnp.zeros(DOUT)}
    return JSession(train_loss_fn=_jquad, eval_loss_fn=_jquad, params=params, net_state={},
                    mode_cfg=JModeConfig(d=ravel_pytree(params)[0].size, **mode),
                    train_set=JFedDataset(x, y, jshard_iid(len(x), num_clients,
                                                           np.random.RandomState(1))),
                    num_workers=workers, local_batch_size=4, seed=0, **kw)


@pytest.mark.parametrize("num_clients, workers, shards, chunk", [
    (32, 12, 8, 0), (20, 17, 8, 0), (12, 6, 4, 0), (12, 8, 2, 3), (12, 8, 4, 4),
    (12, 8, 4, 0)])
def test_session_cohort_rounding_and_chunk_repair_equal_the_reference(
        quad, capsys, num_clients, workers, shards, chunk):
    """The cohort rounds up to a multiple of S (down when the clients cap
    it), and client_chunk is repaired to divide the per-shard cohort, as
    the reference's session does it, with its notes."""
    t = _tsession(num_clients, workers, client_shards=shards, client_chunk=chunk)
    j = _jsession(num_clients, workers, client_shards=shards, client_chunk=chunk)
    out = capsys.readouterr().out.splitlines()
    assert t.num_workers == j.num_workers and t.num_workers % shards == 0
    assert (t.cfg.client_shards, t.cfg.client_chunk) == (j.cfg.client_shards,
                                                         j.cfg.client_chunk)
    notes = [ln for ln in out if ln.startswith("note:")]
    assert len(notes) == 2 * ((workers % shards != 0) + (t.cfg.client_chunk != chunk))
    assert notes[:len(notes) // 2] == notes[len(notes) // 2:]


def test_session_unshardable_cohort_raises_as_the_reference(quad):
    for make in (_tsession, _jsession):
        with pytest.raises(ValueError, match="cannot be sharded.*num_devices"):
            make(4, 4, client_shards=8)


def test_session_client_shards_disagreeing_with_the_mesh_raises(quad):
    """An explicit client_shards (1 included) that disagrees with the mesh
    raises with the reference's message, before any group is needed."""
    for shards in (1, 4):
        with pytest.raises(ValueError, match=f"client_shards={shards} disagrees with the "
                                             "8-way client mesh"):
            _tsession(client_shards=shards, mesh=ClientMesh(clients=8))


def test_session_mesh_needs_a_group_of_its_size(quad):
    """A mesh of S > 1 shards runs one shard per rank: a process that is not
    in a group of S ranks raises and names both launch routes."""
    with pytest.raises(ValueError, match="job of 1 rank.*torchrun.*client_shards"):
        _tsession(mesh=ClientMesh(clients=4))


def test_session_out_of_scope_client_shards_raises_as_the_reference(quad):
    mode = dict(mode="fedavg", momentum=0.0, momentum_type="none", error_type="none",
                num_local_iters=2)
    for make in (_tsession, _jsession):
        with pytest.raises(ValueError, match="sharded-round scope"):
            make(mode=mode, client_shards=4)


def test_session_emulation_routes_and_runs_as_the_reference(quad):
    """client_shards=4 without a mesh: the port's session runs the
    emulation (4 shards, W / 4 clients each), the rounds within atol 1e-5
    of the reference session's (the same cohorts, no dropout)."""
    t, j = _tsession(client_shards=4), _jsession(client_shards=4)
    assert t.cfg.client_shards == 4 and t.group is None and t._rows is None
    for _ in range(3):
        tm, jm = t.run_round(LR), j.run_round(LR)
        assert tm["participants"] == jm["participants"] == 8.0
        np.testing.assert_allclose(tm["loss_sum"], jm["loss_sum"], rtol=1e-5)
    np.testing.assert_allclose(t.state["params"].numpy(),
                               np.asarray(ravel_pytree(j.state["params"])[0]), atol=ATOL)
