"""The port's double-head objective (LM + next-utterance classification)
against the JAX package's, on the CPU, in float32:

- the synthetic MC corpora (easy and ``hard_negatives``, C = 2 and 4) and a
  test-written PersonaChat json with candidates: ids, token types, labels,
  gold positions and client shards byte-equal;
- ``FedTextMCDataset``: ``client_batch`` (L = 1 and 3), ``eval_batches``
  and ``decode_examples`` bitwise against the reference's native sampler,
  ``mc_label`` -100 on padded rows;
- the mc head's forward (LM logits and candidate scores) within atol 1e-5
  at 2 layers x n_embd 64 x 2 heads, T = 32, vocabulary 261;
- ``make_lm_mc_loss``: loss and metrics within rtol 1e-5 (a padded example
  included), the flat gradient within atol 1e-6 (``test_torch_gpt2.py``'s);
- ``FlatLayout`` with ``mc_head``: ``ravel_pytree``'s leaf order at TINY
  and at GPT-2 small, d = 85,453,824 (shapes from ``jax.eval_shape``);
- one FetchSGD round of the MC loss against ``engine.make_round_step``:
  params, Vvelocity and Verror within atol 1e-5 (a top-k swap only at a
  near-tie, 1e-5 of the k-th), metric sums rtol 1e-5
  (``test_torch_gpt2_round.py``'s);
- ``gpt2_train.main --mc_coef 1`` against the JAX CLI from the same flax
  init: every row value within rtol 1e-4, ``mc_acc``/``val_mc_acc``
  present from the first row; ``--mc_coef 1 --num_candidates 1`` refused.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

import gpt2_train as jg2
from commefficient_tpu.data import personachat as jpc
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_lm_mc_loss as jmc
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.data import personachat as tpc
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_lm_mc_loss as tmc
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.sketch import csvec as tcs

torch.set_num_threads(2)

T, V, PAD = 32, 261, 260
JCFG = dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T, with_mc_head=True)
TCFG = dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T, with_mc_head=True)
PERSONAS, SEED = 120, 7


def _same_fed(t, j):
    assert type(t).__name__ == type(j).__name__
    assert t.x.tobytes() == j.x.tobytes() and t.y.tobytes() == j.y.tobytes()
    assert [list(c) for c in t.client_indices] == [list(c) for c in j.client_indices]


@pytest.mark.parametrize("num_candidates,hard", [(2, False), (2, True), (4, True)],
                         ids=["easy_c2", "hard_c2", "hard_c4"])
def test_synthetic_mc_corpus_is_byte_equal(num_candidates, hard):
    kw = dict(num_candidates=num_candidates, mc_hard_negatives=hard)
    jt, jv, _ = jpc.load_personachat_fed("/nonexistent", PERSONAS, T, SEED, **kw)
    tt, tv, _ = tpc.load_personachat_fed("/nonexistent", PERSONAS, T, SEED, **kw)
    _same_fed(tt, jt)
    _same_fed(tv, jv)
    assert isinstance(tt, tpc.FedTextMCDataset) and tt.num_candidates == num_candidates
    gold = tt.y[:, -1]
    assert ((gold >= 0) & (gold < num_candidates)).all() and len(set(gold)) > 1


def test_json_mc_corpus_matches(tmp_path):
    dialog = {"personality": ["i have a cat.", "i love red."],
              "utterances": [{"history": ["hello"],
                              "candidates": ["no", "maybe later", "hi! i like cats"]},
                             {"history": ["hello", "hi! i like cats", "what color?"],
                              "candidates": ["blue", "red, always red"]}]}
    other = {"personality": ["i run."],
             "utterances": [{"history": ["yo"], "candidates": ["i run daily"]}]}
    path = tmp_path / "personachat_self_original.json"
    path.write_text(json.dumps({"train": [dialog, other, dialog], "valid": [other]}))
    for c in (2, 3):
        jt, jv, _ = jpc.load_personachat_fed(str(tmp_path), seq_len=48, seed=3, num_candidates=c)
        tt, tv, _ = tpc.load_personachat_fed(str(tmp_path), seq_len=48, seed=3, num_candidates=c)
        _same_fed(tt, jt)
        _same_fed(tv, jv)
    # a reply without distractors packs all-<pad> candidates beside the gold
    ids = tv.x[0, :3 * 48].reshape(3, 48)
    assert sum((row == PAD).all() for row in ids) == 2


@pytest.fixture(scope="module")
def mc_sets():
    jt, jv, _ = jpc.load_personachat_fed("/nonexistent", PERSONAS, T, SEED, num_candidates=2)
    tt, tv, _ = tpc.load_personachat_fed("/nonexistent", PERSONAS, T, SEED, num_candidates=2)
    return jt, jv, tt, tv


@pytest.mark.parametrize("local_iters", [1, 3])
def test_mc_client_batch_bitwise(mc_sets, local_iters):
    jt, _, tt, _ = mc_sets
    jr, tr = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        ids = jt.sample_clients(jr, 4)
        np.testing.assert_array_equal(tt.sample_clients(tr, 4), ids)
        jb = jt.client_batch(jr, ids, 8, local_iters)
        tb = tt.client_batch(tr, ids, 8, local_iters)
        assert sorted(tb) == sorted(jb) == ["input_ids", "labels", "mc_label", "token_type_ids"]
        lead = (4,) if local_iters == 1 else (4, local_iters)
        assert tb["input_ids"].shape == lead + (8, 2, T) and tb["mc_label"].shape == lead + (8,)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        # a persona with fewer than 8 sets pads with ignored rows
        assert (tb["mc_label"] == -100).any()
        padded = tb["mc_label"] == -100
        assert (tb["labels"][padded] == -100).all()


def test_mc_eval_batches_and_decode_examples_bitwise(mc_sets):
    _, jv, _, tv = mc_sets
    jbs, tbs = list(jv.eval_batches(5)), list(tv.eval_batches(5))
    assert len(tbs) == len(jbs) > 1
    for jb, tb in zip(jbs, tbs):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    got, want = tv.decode_examples(6), jv.decode_examples(6)
    for a, b in zip(got, want):
        assert a.shape == (6, T)
        np.testing.assert_array_equal(a, b)
    assert ((got[2] != -100).sum(axis=1) > 0).all()  # the gold rows carry labels


@pytest.fixture(scope="module")
def models():
    jmodel = jgpt2.GPT2LMHead(JCFG)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32), train=False)["params"])
    tmodel = tgpt2.GPT2LMHead(TCFG)
    tparams, _ = convert.params_from_flax(tmodel, params, {})
    return jmodel, params, tmodel, tparams


def _mc_batch(seed=3, B=3, C=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, size=(B, C, T)).astype(np.int32)
    lengths = rng.randint(8, T + 1, size=(B, C))
    ids[np.arange(T)[None, None] >= lengths[..., None]] = PAD
    types = rng.choice([258, 259], size=(B, C, T)).astype(np.int32)
    mc_label = rng.randint(0, C, size=B).astype(np.int32)
    mc_label[-1] = -100  # a padded example
    labels = np.full((B, C, T), -100, np.int32)
    for b in range(B):
        g = max(mc_label[b], 0)
        labels[b, g, 4:lengths[b, g]] = ids[b, g, 4:lengths[b, g]]
    return {"input_ids": ids, "token_type_ids": types, "labels": labels, "mc_label": mc_label}


def test_mc_head_forward_matches(models):
    jmodel, params, tmodel, tparams = models
    b = _mc_batch()
    ids, types = b["input_ids"].reshape(-1, T), b["token_type_ids"].reshape(-1, T)
    pos = np.array([3, 17, T - 1, 0, 9, 30], np.int32)
    jl, js = jmodel.apply({"params": params}, ids, train=False, token_type_ids=types,
                          mc_positions=pos)
    tl, ts = functional_call(tmodel, tparams, (torch.from_numpy(ids),),
                             {"train": False, "token_type_ids": torch.from_numpy(types),
                              "mc_positions": torch.from_numpy(pos)})
    assert tl.dtype == ts.dtype == torch.float32 and tuple(ts.shape) == (6,)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), atol=1e-5)
    # without mc_positions the head model returns the LM logits alone
    only = functional_call(tmodel, tparams, (torch.from_numpy(ids),),
                           {"train": False, "token_type_ids": torch.from_numpy(types)})
    assert torch.is_tensor(only) and torch.equal(only, tl)


def test_mc_loss_metrics_and_gradient_match(models):
    jmodel, params, tmodel, tparams = models
    batch = _mc_batch()
    jfn = jmc(jmodel, train=False, mc_coef=0.7, pad_id=PAD)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jfn(p, {}, jax.tree.map(jnp.asarray, batch), None), has_aux=True)(params)
    tp = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tl, taux = tmc(tmodel, train=False, mc_coef=0.7, pad_id=PAD)(
        tp, {}, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert sorted(taux["metrics"]) == sorted(jaux["metrics"])
    for k, v in jaux["metrics"].items():
        np.testing.assert_allclose(taux["metrics"][k].item(), float(v), rtol=1e-5, err_msg=k)
    assert taux["metrics"]["mc_count"].item() == 2.0  # the padded example is masked
    grads = torch.autograd.grad(tl, list(tp.values()))
    layout = convert.FlatLayout(tmodel)
    np.testing.assert_allclose(layout.flatten(dict(zip(tp, grads))).numpy(),
                               np.asarray(ravel_pytree(jg)[0]), atol=1e-6)


def _flax_leaves(cfg, seq_len):
    shapes = jax.eval_shape(lambda: jgpt2.GPT2LMHead(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, seq_len), jnp.int32), train=False))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return [(tuple(k.key for k in path), leaf.shape) for path, leaf in flat]


@pytest.mark.parametrize("size", ["tiny", "small"])
def test_flat_layout_with_mc_head_is_ravel_order(size):
    if size == "tiny":
        jcfg, tcfg, seq = JCFG, TCFG, T
    else:
        jcfg = dataclasses.replace(jgpt2.SMALL, vocab_size=V, n_positions=256, with_mc_head=True)
        tcfg = dataclasses.replace(tgpt2.SMALL, vocab_size=V, n_positions=256, with_mc_head=True)
        seq = 256
    want = _flax_leaves(jcfg, seq)
    with torch.device("meta"):
        layout = convert.FlatLayout(tgpt2.GPT2LMHead(tcfg))
    got = [(convert.flax_path(leaf.name), leaf.flax_shape) for leaf in layout.leaves]
    assert got == want
    names = [leaf.name for leaf in layout.leaves]
    assert names[-3:] == ["mc_head", "wpe", "wte"] and names[-4] == "ln_f.weight"
    if size == "small":
        assert layout.d == 85_453_824 == 85_453_056 + 768


def test_mc_sketch_round_matches_jax(models, mc_sets):
    jmodel, params, tmodel, tparams = models
    _, _, tt, _ = mc_sets
    W, B, C, R, K, LR, WD = 2, 2, 4096, 5, 500, 0.05, 5e-4
    rng = np.random.RandomState(1)
    batch = tt.client_batch(rng, tt.sample_clients(rng, W), B)
    batch["_valid"] = np.ones(W, np.float32)
    d = ravel_pytree(params)[0].size
    mode_kw = dict(mode="sketch", k=K, num_rows=R, num_cols=C, seed=42, momentum=0.9,
                   momentum_type="virtual", error_type="virtual", hash_family="rotation")
    ms = {"Vvelocity": (1e-3 * rng.standard_normal((R, C))).astype(np.float32),
          "Verror": (1e-4 * rng.standard_normal((R, C))).astype(np.float32)}
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    jstate = jengine.init_server_state(jcfg, params, {})
    jstate["mode_state"] = {k: jnp.asarray(v) for k, v in ms.items()}
    jstep = jax.jit(jengine.make_round_step(jmc(jmodel, True, 1.0, PAD), jcfg))
    jnew, _, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(LR),
                        jax.random.PRNGKey(0))
    layout = convert.FlatLayout(tmodel)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    tstate = tengine.init_server_state(tcfg, layout.flatten(tparams), {})
    tstate["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in ms.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tmc(tmodel, True, 1.0, PAD)
    tnew, _, tm = tengine.make_round_step(loss, tcfg, layout)(tstate, tb, {}, LR)
    for k in ("loss_sum", "count", "correct", "mc_loss_sum", "mc_count", "mc_correct",
              "participants"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    p0 = np.asarray(ravel_pytree(params)[0])
    jp, tp = np.asarray(ravel_pytree(jnew["params"])[0]), tnew["params"].numpy()
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    assert len(j_set) == len(t_set) == K
    differ = j_set ^ t_set
    if differ:
        weighted, _, _ = tengine.reduce_clients(loss, tcfg, layout, tstate, tb)
        spec = tcfg.mode.sketch_spec
        E = tstate["mode_state"]["Verror"] + LR * (
            0.9 * tstate["mode_state"]["Vvelocity"] + tcs.sketch_vec(spec, weighted))
        est = tcs.query_all(spec, E).abs()
        kth = torch.topk(est, K).values[-1].item()
        for i in differ:
            assert abs(est[i].item() - kth) <= 1e-5 * kth, (i, est[i].item(), kth)
    same = np.array(sorted(j_set & t_set))
    np.testing.assert_allclose(tp[same], jp[same], atol=1e-5)
    for k in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(tnew["mode_state"][k].numpy(),
                                   np.asarray(jnew["mode_state"][k]), atol=1e-5, err_msg=k)


@pytest.fixture()
def flax_init(monkeypatch):
    """The port's CLI starts from the flax init of the seed (the mc head
    included), as the JAX CLI's does."""

    def init_from_flax(model, seed):
        cfg = dataclasses.replace(jgpt2.TINY, vocab_size=model.cfg.vocab_size,
                                  n_positions=model.cfg.n_positions,
                                  with_mc_head=model.cfg.with_mc_head, dtype=model.cfg.dtype)
        params = jgpt2.GPT2LMHead(cfg).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, model.cfg.n_positions), jnp.int32),
            train=False)["params"]
        tparams, _ = convert.params_from_flax(model, jax.tree.map(np.asarray, params), {})
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(tparams[name])

    monkeypatch.setattr(tg2, "init_weights", init_from_flax)


MC_CLI = ["--model_size", "tiny", "--seq_len", str(T), "--num_clients", "12",
          "--num_workers", "2", "--local_batch_size", "2", "--lr_scale", "0.1",
          "--pivot_epoch", "0.1", "--num_rounds", "2", "--eval_every", "1",
          "--eval_batch_size", "8", "--data_root", "/nonexistent", "--mc_coef", "1",
          "--num_candidates", "2", "--mode", "sketch", "--k", "5000", "--num_cols", "8192"]
MC_ROW_KEYS = ("epoch", "lr", "train_nll", "train_ppl", "val_nll", "val_ppl", "comm_mb",
               "mc_acc", "val_mc_acc")


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_mc_cli_matches_jax(flax_init, tmp_path):
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    js = jg2.main(MC_CLI + ["--sync_loop", "--num_devices", "1", "--log_jsonl", jlog])
    ts = tg2.main(MC_CLI + ["--device", "cpu", "--log_jsonl", tlog])
    assert js.round == ts.round == 2 and ts.layout.d == ravel_pytree(js.state["params"])[0].size
    jrows, trows = _rows(jlog), _rows(tlog)
    assert [r["round"] for r in trows] == [r["round"] for r in jrows] == [1, 2]
    assert list(trows[0]) == list(jrows[0])  # the mc columns from the first row
    for jr, tr in zip(jrows, trows):
        for k in MC_ROW_KEYS:
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, err_msg=(tr, k))
    assert 0.0 <= trows[-1]["mc_acc"] <= 1.0 and np.isfinite(trows[-1]["val_nll"])


def test_mc_cli_needs_two_candidates():
    with pytest.raises(SystemExit, match="--num_candidates >= 2"):
        tg2.main(MC_CLI[:MC_CLI.index("--num_candidates")] + [
            "--num_candidates", "1", "--device", "cpu"])
