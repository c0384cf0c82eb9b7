"""The batched client phase: one ``torch.func.vmap`` over the cohort, and
``client_chunk`` C > 0 (W / C vmapped chunks, their sums added in chunk
order), held against the JAX package's round at the same ``client_chunk``.

Against the reference: the tests' tiny net (tests/test_torch_runner.py's
``TinyNet`` and its flax twin, d = 98,666), W = 4 clients x B = 4 rows,
one padded row, every mode: new params, Vvelocity, Verror and client rows
within atol 1e-5, metric sums within rtol 1e-5, as tests/test_torch_round.py
holds them (the two packages' CPU products sum in other orders, about 1e-7
relative); a top-k may swap a coordinate at a near-tie of its k-th
magnitude (at most 2 here), whose state the comparison then leaves out.
The payload round (``make_payload_round_steps``) likewise, table by table.

Inside the port: chunk 0, 1, 2 and 4 of one round agree within atol 1e-6
(a vmap over more clients runs its products at another batch size); a
masked client's NaN contributes an exact zero at every chunk. GPT-2 (2
layers, 64 wide, dropout 0.1): the masks the vmapped step reads are
bitwise its per-(round, slot, step) generators' masks, a chunk-0 round is
a chunk-1 round within atol 1e-6, and with local steps the async loop, the
sync loop and a resumed run are bitwise equal at chunk 0. The bf16 GELU
under ``vmap(grad)`` is bitwise the unbatched function row by row, and no
model's vmapped step falls back to functorch's per-client loop.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.models import convert, gpt2
from commefficient_tpu_torch.models.femnist_cnn import FEMNISTCNN
from commefficient_tpu_torch.models.losses import (make_classification_loss, make_lm_loss,
                                                   make_lm_mc_loss)
from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
from commefficient_tpu_torch.modes import modes
from commefficient_tpu_torch.modes.config import ModeConfig
from commefficient_tpu_torch.sketch import csvec
from test_torch_cohort_faults import _image_batch, _tiny_pair
from test_torch_loop_parity import TINY_PATHS
from test_torch_runner import _args, _argv, tiny_cv  # noqa: F401

torch.set_num_threads(2)

W, B, K = 4, 4, 100
LR, WD = 0.05, 5e-4
ATOL = 1e-5
V = dict(momentum=0.9, momentum_type="virtual")
MODES = {
    "sketch": dict(mode="sketch", k=K, num_rows=3, num_cols=2000, error_type="virtual", **V),
    "true_topk": dict(mode="true_topk", k=K, error_type="virtual", **V),
    "uncompressed": dict(mode="uncompressed", error_type="none", **V),
    "local_topk": dict(mode="local_topk", k=K, momentum=0.9, momentum_type="local",
                       error_type="local", num_clients=6),
    "fedavg": dict(mode="fedavg", error_type="none", num_local_iters=2, **V),
    "true_topk_sketch_state": dict(mode="true_topk", k=K, error_type="virtual",
                                   server_state="sketch", num_rows=3, num_cols=2000, **V),
}


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)
    return _tiny_pair()


def _batch(mcfg, seed=1):
    """[W, B] image rows (fedavg: [W, L, B]), one padded row."""
    L = mcfg.num_local_iters
    rng = np.random.RandomState(seed)
    lead = (W, L, B) if mcfg.uses_weight_delta and L > 1 else (W, B)
    mask = np.ones(lead, np.float32)
    mask[1, ..., 1] = 0.0
    return {"x": rng.standard_normal(lead + (32, 32, 3)).astype(np.float32),
            "y": rng.randint(0, 10, lead).astype(np.int32), "mask": mask,
            "_valid": np.ones(W, np.float32)}


def _state_np(mcfg, d, seed=2):
    rng = np.random.RandomState(seed)
    shape = modes.init_server_state(mcfg, "cpu")["Vvelocity"].shape
    ms = {"Vvelocity": (1e-3 * rng.standard_normal(shape)).astype(np.float32),
          "Verror": (1e-4 * rng.standard_normal(shape)).astype(np.float32)}
    rows = {k: (0.01 * rng.standard_normal((W, d))).astype(np.float32)
            for k in (modes.init_client_state(mcfg) or {})}
    return ms, rows


def _port_step(tmodel, mcfg, **eng_kw):
    layout = convert.FlatLayout(tmodel)
    cfg = engine.EngineConfig(mode=mcfg, weight_decay=WD, on_nonfinite="skip", **eng_kw)
    state = engine.init_server_state(
        cfg, layout.flatten({k: v.detach() for k, v in tmodel.named_parameters()}), {})
    return cfg, layout, state


def _swaps(mcfg, p0, jp, tp):
    """Coordinates one side moved and the other did not (a near-tie of the
    k-th magnitude), at most 2; the state masks that leave them out."""
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    differ = sorted(j_set ^ t_set)
    assert len(differ) <= 2, differ
    return differ, np.array(sorted(j_set & t_set), dtype=np.int64)


def _state_keep(mcfg, shape, differ):
    keep = np.ones(shape, bool)
    if not differ:
        return keep
    if len(shape) == 1:
        keep[differ] = False
    else:  # a sketch table: the swapped coordinates' buckets
        buckets, _ = csvec._block_hashes(mcfg.sketch_spec, torch.tensor(differ), torch.float32)
        for r in range(mcfg.sketch_spec.r):
            keep[r, buckets[r].numpy()] = False
    return keep


@pytest.mark.parametrize("chunk", [0, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_round_matches_the_reference_at_the_same_chunk(tiny, mode, chunk):
    fmodel, params, tmodel = tiny
    d = ravel_pytree(params)[0].size
    mode_kw = MODES[mode]
    mcfg = ModeConfig(d=d, **mode_kw)
    batch = _batch(mcfg)
    ms, rows = _state_np(mcfg, d)

    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip", client_chunk=chunk)
    jstate = jengine.init_server_state(jcfg, params, {})
    jstate["mode_state"] = {k: jnp.asarray(v) for k, v in ms.items()}
    jnew, jrows, jm = jax.jit(jengine.make_round_step(jloss(fmodel, True), jcfg))(
        jstate, jax.tree.map(jnp.asarray, batch), {k: jnp.asarray(v) for k, v in rows.items()},
        jnp.float32(LR), jax.random.PRNGKey(0))

    cfg, layout, tstate = _port_step(tmodel, mcfg, client_chunk=chunk)
    tstate["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in ms.items()}
    tnew, trows, tm = engine.make_round_step(
        make_classification_loss(tmodel, True), cfg, layout)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v.copy()) for k, v in rows.items()}, LR)

    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    p0 = tstate["params"].numpy()
    jp, tp = np.asarray(ravel_pytree(jnew["params"])[0]), tnew["params"].numpy()
    differ, same = _swaps(mcfg, p0, jp, tp)
    gap = float(np.abs(tp[same] - jp[same]).max()) if len(same) else 0.0
    np.testing.assert_allclose(tp[same], jp[same], rtol=0, atol=ATOL)
    if mode in ("uncompressed", "fedavg"):
        np.testing.assert_allclose(tp, jp, rtol=0, atol=ATOL)
    for k, v in tnew["mode_state"].items():
        want = np.asarray(jnew["mode_state"][k])
        keep = _state_keep(mcfg, want.shape, differ)
        gap = max(gap, float(np.abs(v.numpy()[keep] - want[keep]).max()))
        np.testing.assert_allclose(v.numpy()[keep], want[keep], rtol=0, atol=ATOL, err_msg=k)
    assert trows.keys() == rows.keys()
    for k, v in trows.items():
        # a client's own top-k may swap a near-tie too: at most 2 entries
        for w in range(W):
            bad = np.flatnonzero(np.abs(v[w].numpy() - np.asarray(jrows[k][w])) > ATOL)
            assert len(bad) <= 2, (k, w, bad)
        assert not np.array_equal(v.numpy(), rows[k])  # every client took part
    # the measured largest gap (params on the coordinates both moved,
    # Vvelocity, Verror), shown with -s
    print(f"reference gap {mode} chunk {chunk}: {gap:.3e} ({len(differ)} top-k swaps)")


@pytest.mark.parametrize("eng_kw", [{}, {"dp_clip": 0.5}], ids=["plain", "dp_clip"])
def test_payload_round_matches_the_reference(tiny, eng_kw):
    """The wire-payload round's client step (one vmap of all W, then one
    table per row) and merge against the reference's pair, with a masked
    NaN client: every table within atol 1e-5, the merged round's params and
    state as above."""
    fmodel, params, tmodel = tiny
    d = ravel_pytree(params)[0].size
    mode_kw = MODES["sketch"]
    mcfg = ModeConfig(d=d, **mode_kw)
    batch = _batch(mcfg)
    batch["_valid"][2] = 0.0
    batch["x"][2] = np.nan
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip", wire_payloads=True, **eng_kw)
    jclient, jmerge = jengine.make_payload_round_steps(jloss(fmodel, True), jcfg)
    jstate = jengine.init_server_state(jcfg, params, {})
    jt, jns, jmv, jpart, nrng, _ = jax.jit(jclient)(
        jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    jnew, jm = jax.jit(jmerge)(jstate, jt, jns, jmv, jpart, jnp.ones(W), jnp.float32(LR), nrng)

    cfg, layout, tstate = _port_step(tmodel, mcfg, wire_payloads=True, **eng_kw)
    tclient, tmerge = engine.make_payload_round_steps(
        make_classification_loss(tmodel, True), cfg, layout)
    tt, tns, tmv, tpart, _ = tclient(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))
    for w in (0, 1, 3):
        np.testing.assert_allclose(tt[w].numpy(), np.asarray(jt[w]), rtol=0, atol=ATOL)
    tnew, tm = tmerge(tstate, tt, tns, tmv, tpart, torch.ones(W), torch.tensor(LR))
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["participants"]) == 3
    p0 = tstate["params"].numpy()
    jp, tp = np.asarray(ravel_pytree(jnew["params"])[0]), tnew["params"].numpy()
    differ, same = _swaps(mcfg, p0, jp, tp)
    np.testing.assert_allclose(tp[same], jp[same], rtol=0, atol=ATOL)
    for k, v in tnew["mode_state"].items():
        want = np.asarray(jnew["mode_state"][k])
        keep = _state_keep(mcfg, want.shape, differ)
        np.testing.assert_allclose(v.numpy()[keep], want[keep], rtol=0, atol=ATOL, err_msg=k)


# ------------------------------------------------------- inside the port


def _rounds_by_chunk(tmodel, mode_kw, batch, chunks, **eng_kw):
    d = convert.FlatLayout(tmodel).d
    mcfg = ModeConfig(d=d, **mode_kw)
    out = {}
    for c in chunks:
        cfg, layout, state = _port_step(tmodel, mcfg, client_chunk=c, **eng_kw)
        out[c] = engine.make_round_step(make_classification_loss(tmodel, True), cfg, layout)(
            state, {k: torch.as_tensor(v) for k, v in batch.items()}, {}, LR)
    return out, state


@pytest.mark.parametrize("mode", ["uncompressed", "sketch", "fedavg"])
def test_chunks_agree(tiny, mode):
    """Chunk 0, 1, 2 and 4 of one round at W = 8: params and server state
    within atol 1e-6 of chunk 0's (a top-k swap only at a near-tie), metric
    sums within rtol 1e-6. fedavg ignores the knob: bitwise."""
    _, _, tmodel = tiny
    batch = _image_batch(8, B=2)
    if mode == "fedavg":  # [W, L, B] microbatches of the 2 local steps
        batch = {k: v.reshape((8, 2) + v.shape[1:])
                 for k, v in _image_batch(16, B=2).items()}
    batch["_valid"] = np.ones(8, np.float32)
    out, state = _rounds_by_chunk(tmodel, MODES[mode], batch, (0, 1, 2, 4))
    mcfg = ModeConfig(d=state["params"].numel(), **MODES[mode])
    p0 = state["params"].numpy()
    (s0, _, m0) = out[0]
    for c in (1, 2, 4):
        sc, _, mc = out[c]
        if mode == "fedavg":
            assert torch.equal(sc["params"], s0["params"])
        differ, same = _swaps(mcfg, p0, s0["params"].numpy(), sc["params"].numpy())
        np.testing.assert_allclose(sc["params"].numpy()[same], s0["params"].numpy()[same],
                                   rtol=0, atol=1e-6)
        for k, v in sc["mode_state"].items():
            keep = _state_keep(mcfg, tuple(v.shape), differ)
            np.testing.assert_allclose(v.numpy()[keep], s0["mode_state"][k].numpy()[keep],
                                       rtol=0, atol=1e-6, err_msg=(c, k))
        for k in m0:
            np.testing.assert_allclose(float(mc[k]), float(m0[k]), rtol=1e-6, err_msg=(c, k))


@pytest.mark.parametrize("chunk", [0, 1, 2, 4])
def test_masked_nan_client_adds_an_exact_zero_at_every_chunk(tiny, chunk):
    """A client behind a zero validity holding NaN gives, bitwise, the
    round a zeroed client gives, with the DP clip on (its factor stays 1)."""
    _, _, tmodel = tiny
    batch = _image_batch(8, B=2)
    batch["_valid"] = np.ones(8, np.float32)
    batch["_valid"][5] = 0.0
    zeroed = dict(batch, x=batch["x"].copy())
    zeroed["x"][5] = 0.0
    poisoned = dict(batch, x=batch["x"].copy())
    poisoned["x"][5] = np.nan
    a, _ = _rounds_by_chunk(tmodel, MODES["sketch"], zeroed, (chunk,), dp_clip=1.0)
    b, _ = _rounds_by_chunk(tmodel, MODES["sketch"], poisoned, (chunk,), dp_clip=1.0)
    (sa, _, ma), (sb, _, mb) = a[chunk], b[chunk]
    assert torch.equal(sa["params"], sb["params"])
    for k in sa["mode_state"]:
        assert torch.equal(sa["mode_state"][k], sb["mode_state"][k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert ma["participants"].item() == 7 and torch.isfinite(sa["params"]).all()


def test_local_topk_rows_are_the_row_by_row_compress(tiny):
    """local_topk: each client's new rows are modes.client_compress of its
    own (vmapped) update and its own rows, in cohort order, bitwise; a
    client that does not take part keeps its rows."""
    _, _, tmodel = tiny
    d = convert.FlatLayout(tmodel).d
    mcfg = ModeConfig(d=d, **MODES["local_topk"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(mcfg).items()}
    batch["_valid"][3] = 0.0
    _, rows = _state_np(mcfg, d)
    rows = {k: torch.from_numpy(v) for k, v in rows.items()}
    cfg, layout, state = _port_step(tmodel, mcfg)
    loss_fn = make_classification_loss(tmodel, True)
    _, new_rows, _ = engine.make_round_step(loss_fn, cfg, layout)(state, batch, rows, LR)
    ups, _, _ = engine.make_client_updates(loss_fn, cfg, layout)(
        state, {k: v for k, v in batch.items() if k != "_valid"}, None, range(W))
    for w in range(W):
        _, want = modes.client_compress(mcfg, ups[w], {k: v[w] for k, v in rows.items()})
        for k in rows:
            expect = rows[k][w] if w == 3 else want[k]
            assert torch.equal(new_rows[k][w], expect), (w, k)


# ------------------------------------------------------------------ GPT-2


def _gpt2(dtype="float32", mc=False, dropout=0.1):
    cfg = dataclasses.replace(gpt2.TINY, n_embd=64, n_layer=2, n_head=2, dropout=dropout,
                              dtype=dtype, with_mc_head=mc)
    model = gpt2.GPT2LMHead(cfg)
    gpt2.init_weights(model, 0)
    loss = make_lm_mc_loss(model, True, 1.0, 0) if mc else make_lm_loss(model, True)
    return model, loss


def _token_batch(mc=False, n=W, T=16, seed=0):
    rng = np.random.RandomState(seed)
    shape = (n, 2, 2, T) if mc else (n, 2, T)
    batch = {k: torch.from_numpy(rng.randint(1, 500, shape).astype(np.int32))
             for k in ("input_ids", "token_type_ids", "labels")}
    if mc:
        batch["mc_label"] = torch.from_numpy(rng.randint(0, 2, (n, 2)).astype(np.int32))
    return batch


def _lm_engine(model, loss, **eng_kw):
    layout = convert.FlatLayout(model)
    cfg = engine.EngineConfig(mode=ModeConfig(mode="uncompressed", d=layout.d,
                                              error_type="none", **V), seed=7, **eng_kw)
    state = engine.init_server_state(
        cfg, layout.flatten({k: v.detach() for k, v in model.named_parameters()}), {})
    return cfg, layout, state


@pytest.mark.parametrize("mc", [False, True], ids=["lm", "mc"])
def test_vmapped_masks_are_the_generators_masks(mc):
    """The masks the vmapped step reads (drawn for all W at once, stacked)
    are bitwise the ones each client's (round, slot, step) generator gives
    at the forward's draws; a forward reading them equals, bitwise, the
    forward drawing from the generator."""
    model, loss = _gpt2(mc=mc)
    cfg, layout, state = _lm_engine(model, loss)
    batch = _token_batch(mc)
    rnd = 3
    stacked = engine._draw_masks(loss, cfg, rnd, range(W), 0, batch, torch.device("cpu"))
    assert len(stacked) == 1 + 3 * model.cfg.n_layer
    leaves = layout.unflatten(state["params"])
    for w in range(W):
        cb = {k: v[w] for k, v in batch.items()}
        own = loss.dropout_masks(cb, cfg.generator(rnd, w, 0, torch.device("cpu")))
        assert all(torch.equal(s[w], m) for s, m in zip(stacked, own))
        gen = cfg.generator(rnd, w, 0, torch.device("cpu"))
        first = torch.rand(own[0].shape, generator=gen) < 1.0 - model.cfg.dropout
        assert torch.equal(first, own[0])
        with torch.no_grad():
            by_gen = loss(leaves, {}, cb, cfg.generator(rnd, w, 0, torch.device("cpu")))[1]
            by_masks = loss(leaves, {}, cb, [s[w] for s in stacked])[1]
        for k in by_gen["metrics"]:
            assert torch.equal(by_gen["metrics"][k], by_masks["metrics"][k]), (w, k)


def test_gpt2_forward_refuses_unread_masks():
    model, loss = _gpt2()
    cfg, layout, state = _lm_engine(model, loss)
    cb = {k: v[0] for k, v in _token_batch().items()}
    masks = loss.dropout_masks(cb, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="left over"):
        loss(layout.unflatten(state["params"]), {}, cb, masks + masks[:1])


@pytest.mark.parametrize("dtype,mc", [("float32", False), ("bfloat16", True)],
                         ids=["lm_f32", "mc_bf16"])
def test_gpt2_chunk_0_round_equals_chunk_1_round(dtype, mc):
    """One GPT-2 round with dropout on at chunk 0 and at chunk 1: the same
    masks, params within atol 1e-6, metric sums within rtol 1e-6."""
    model, loss = _gpt2(dtype, mc)
    batch = dict(_token_batch(mc), _valid=torch.ones(W))
    outs = {}
    for c in (0, 1):
        cfg, layout, state = _lm_engine(model, loss, client_chunk=c)
        outs[c] = engine.make_round_step(loss, cfg, layout)(state, batch, {}, LR)
    (s0, _, m0), (s1, _, m1) = outs[0], outs[1]
    assert not torch.equal(s0["params"], state["params"])
    torch.testing.assert_close(s0["params"], s1["params"], rtol=0, atol=1e-6)
    for k in m0:
        torch.testing.assert_close(m0[k], m1[k], rtol=1e-6, atol=0)


@pytest.fixture()
def dropout_on(monkeypatch):
    monkeypatch.setattr(tg2, "TINY", dataclasses.replace(gpt2.TINY, dropout=0.1))


GPT2_CLI = ["--model_size", "tiny", "--seq_len", "16", "--num_clients", "12",
            "--num_workers", "4", "--local_batch_size", "2", "--lr_scale", "0.5",
            "--pivot_epoch", "0.1", "--num_rounds", "4", "--eval_every", "2",
            "--eval_batch_size", "8", "--data_root", "/nonexistent", "--device", "cpu",
            "--mode", "fedavg", "--num_local_iters", "2", "--client_chunk", "0"]


def test_gpt2_local_steps_async_equals_sync_and_resume(dropout_on, tmp_path):
    """fedavg with 2 local steps, dropout on, chunk 0: every step's masks
    come from its (round, slot, step) generator, so the async loop, the
    sync loop and a preempted-then-resumed run end bitwise equal, with no
    generator state in the checkpoint."""
    s = tg2.main(GPT2_CLI + ["--sync_loop"])
    a = tg2.main(GPT2_CLI)
    assert s.cfg.client_chunk == 0
    assert torch.equal(a.state["params"], s.state["params"])
    ck = ["--checkpoint_dir", str(tmp_path / "ck"), "--fault_plan", "preempt@2"]
    with pytest.raises(SystemExit) as ei:
        tg2.main(GPT2_CLI + ck)
    assert ei.value.code == 75
    r = tg2.main(GPT2_CLI + ck + ["--resume"])
    assert r.run_stats.rounds == 1 and torch.equal(r.state["params"], s.state["params"])


def test_bf16_gelu_under_vmap_grad_is_the_unbatched_function():
    """``_GeluBF16`` under vmap(grad) gives, row by row, bitwise what the
    unbatched function's autograd gives."""
    x = torch.randn(4, 3, 33, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    g = torch.randn(4, 3, 33, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)

    def f(xi, gi):
        return (gpt2.gelu(xi).float() * gi.float()).sum()

    got = torch.func.vmap(torch.func.grad(f))(x, g)
    ys = torch.func.vmap(gpt2.gelu)(x)
    for w in range(4):
        xi = x[w].clone().requires_grad_(True)
        y = gpt2.gelu(xi)
        (want,) = torch.autograd.grad((y.float() * g[w].float()).sum(), xi)
        assert torch.equal(got[w], want), w
        assert torch.equal(ys[w], y.detach()), w


def _no_fallback(loss_fn, model, batch, net_state=None, mode="uncompressed"):
    layout = convert.FlatLayout(model)
    cfg = engine.EngineConfig(mode=ModeConfig(mode=mode, d=layout.d, error_type="none"))
    state = engine.init_server_state(
        cfg, layout.flatten({k: v.detach() for k, v in model.named_parameters()}),
        net_state or {})
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            u, _, _ = engine.make_client_updates(loss_fn, cfg, layout)(
                state, batch, None, range(next(iter(batch.values())).shape[0]))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert torch.isfinite(u).all()


@pytest.mark.parametrize("model", ["resnet9", "resnet9_bf16", "femnist"])
def test_no_batching_rule_fallback_cv(model):
    """functorch warns when a missing batching rule makes it loop over the
    clients; the warning is an error here."""
    rng = np.random.RandomState(0)
    if model.startswith("resnet9"):
        m = ResNet9(dtype="bfloat16" if model.endswith("bf16") else "float32")
        init_weights(m, 0)
        x = rng.standard_normal((2, 2, 32, 32, 3))
    else:
        m = FEMNISTCNN(num_classes=62)
        x = rng.standard_normal((2, 2, 28, 28, 1))
    batch = {"x": torch.from_numpy(x.astype(np.float32)), "y": torch.zeros(2, 2, dtype=torch.int32),
             "mask": torch.ones(2, 2)}
    _no_fallback(make_classification_loss(m, True), m, batch,
                 {k: b.clone() for k, b in m.named_buffers()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mc", [False, True], ids=["lm", "mc"])
def test_no_batching_rule_fallback_gpt2(dtype, mc):
    model, loss = _gpt2(dtype, mc)
    _no_fallback(loss, model, _token_batch(mc, n=2))


def test_sketch_refuses_a_transformed_tensor():
    """The sketch never runs under a map: csvec (and the kernels' wrapper)
    raise on a torch.func tensor instead of sketching it silently."""
    spec = csvec.CSVecSpec(d=300, c=64, r=3, seed=0, family="rotation")
    with pytest.raises(ValueError, match="torch.func"):
        torch.func.vmap(lambda v: csvec.sketch_vec(spec, v))(torch.randn(2, 300))
    with pytest.raises(ValueError, match="torch.func"):
        torch.func.vmap(lambda t: csvec.query_all(spec, t))(torch.randn(2, 3, 64))


# ------------------------------------------------------ session and CLI


def test_divisor_repair_prints_the_reference_note(tiny_cv, capsys):  # noqa: F811
    """--client_chunk 3 at W = 8 runs with 2 and says so, as the reference
    repairs it."""
    s, _ = tcv.build(_args(("--num_workers", "8", "--client_chunk", "3")))
    assert s.cfg.client_chunk == 2
    assert ("note: client_chunk=3 does not divide the cohort (8); using client_chunk=2"
            in capsys.readouterr().out)
    s.run_round(0.1)
    assert torch.isfinite(s.state["params"]).all()


def test_negative_client_chunk_is_refused(tiny_cv):  # noqa: F811
    with pytest.raises(ValueError, match="client_chunk"):
        tcv.build(_args(("--client_chunk", "-1")))
    with pytest.raises(ValueError, match="client_chunk"):
        engine.EngineConfig(mode=ModeConfig(mode="uncompressed", d=10, error_type="none"),
                            client_chunk=-2)


def test_resume_keeps_the_checkpoints_client_chunk(tiny_cv, tmp_path, capsys):  # noqa: F811
    """meta.json records client_chunk; a resume asking for another runs at
    the recorded one, and ends bitwise on the uninterrupted run."""
    from commefficient_tpu_torch.utils import checkpoint as ckpt

    run = ("--num_workers", "4", "--num_rounds", "4")
    ck = ("--checkpoint_dir", str(tmp_path))
    full = tcv.main(_argv(run + ("--client_chunk", "2")))
    with pytest.raises(SystemExit):
        tcv.main(_argv(run + ck + ("--client_chunk", "2", "--fault_plan", "preempt@1")))
    meta = ckpt.latest(str(tmp_path))
    assert '"client_chunk": 2' in open(f"{meta}/meta.json").read()
    r = tcv.main(_argv(run + ck + ("--client_chunk", "0", "--resume")))
    assert "resuming at it" in capsys.readouterr().out
    assert r.cfg.client_chunk == 2
    assert torch.equal(r.state["params"], full.state["params"])
