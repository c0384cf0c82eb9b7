"""The port's GPT-2 slice end to end on the CPU, against the JAX package
where the two can agree (dropout 0), at 2 layers x n_embd 64 x 2 heads,
vocabulary 261, T = 32, and against itself with dropout 0.1:

- one FetchSGD round (rotation sketch) and one uncompressed round against
  ``engine.make_round_step`` on the same flax weights, server state and
  synthetic PersonaChat batch: new params, Vvelocity and Verror within
  atol 1e-5 (the sketch round's released top-k sets may differ only at a
  near-tie, an estimate within 1e-5 of the k-th), metric sums rtol 1e-5;
- a round over a dict batch without an "x" key and without the validity
  mask runs (the cohort size comes from any leaf);
- ``gpt2_train.main`` against the JAX CLI at --model_size tiny (dropout 0)
  for 2 rounds, each starting from the flax init of the seed: every row
  value within rtol 1e-4, comm_mb equal;
- with dropout 0.1 through the port's CLI: the async loop equals the sync
  loop bitwise, and preempt -> exit 75 -> resume equals the uninterrupted
  run bitwise, with no generator state in the checkpoint;
- the dropout seeds are a pure function of (seed, round, slot, step).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import gpt2_train as jg2
from commefficient_tpu.data.personachat import load_personachat_fed as jload
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_lm_loss as jloss
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_lm_loss as tloss
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.sketch import csvec as tcs

torch.set_num_threads(2)

T, V, W, B = 32, 261, 2, 2
C, R, K = 4096, 5, 500
LR, WD, ATOL = 0.05, 5e-4, 1e-5
JCFG = dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T)
TCFG = dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T)


@pytest.fixture(scope="module")
def setup():
    jmodel = jgpt2.GPT2LMHead(JCFG)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, T), jnp.int32), train=False)["params"])
    tmodel = tgpt2.GPT2LMHead(TCFG)
    tparams, _ = convert.params_from_flax(tmodel, params, {})
    train, _, _ = jload("/nonexistent", 40, T, 0)
    rng = np.random.RandomState(1)
    batch = train.client_batch(rng, train.sample_clients(rng, W), B)
    batch["_valid"] = np.ones(W, np.float32)
    return jmodel, params, tmodel, tparams, batch


def _run_both(setup, mode_kw, mode_state_np):
    jmodel, params, tmodel, tparams, batch = setup
    d = ravel_pytree(params)[0].size
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    jstate = jengine.init_server_state(jcfg, params, {})
    jstate["mode_state"] = {k: jnp.asarray(v) for k, v in mode_state_np.items()}
    jstep = jax.jit(jengine.make_round_step(jloss(jmodel, True), jcfg))
    jnew, _, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(LR),
                        jax.random.PRNGKey(0))

    layout = convert.FlatLayout(tmodel)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    tstate0 = tengine.init_server_state(tcfg, layout.flatten(tparams), {})
    tstate0["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in mode_state_np.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnew, _, tm = tengine.make_round_step(tloss(tmodel, True), tcfg, layout)(
        tstate0, tb, {}, LR)
    for k in ("loss_sum", "count", "correct", "participants", "nonfinite_rounds"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert tnew["net_state"] == {}
    p0 = np.asarray(ravel_pytree(params)[0])
    jp = np.asarray(ravel_pytree(jnew["params"])[0])
    return layout, tcfg, tstate0, tb, p0, jp, tnew["params"].numpy(), jnew["mode_state"], \
        tnew["mode_state"]


def test_sketch_round_matches_jax(setup):
    mode_kw = dict(mode="sketch", k=K, num_rows=R, num_cols=C, seed=42, momentum=0.9,
                   momentum_type="virtual", error_type="virtual", hash_family="rotation")
    rng = np.random.RandomState(1)
    ms = {"Vvelocity": (1e-3 * rng.standard_normal((R, C))).astype(np.float32),
          "Verror": (1e-4 * rng.standard_normal((R, C))).astype(np.float32)}
    layout, tcfg, tstate0, tb, p0, jp, tp, jms, tms = _run_both(setup, mode_kw, ms)
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    assert len(j_set) == len(t_set) == K
    differ = j_set ^ t_set
    if differ:
        weighted, _, _ = tengine.reduce_clients(tloss(setup[2], True), tcfg, layout,
                                                tstate0, tb)
        spec = tcfg.mode.sketch_spec
        E = tstate0["mode_state"]["Verror"] + LR * (
            0.9 * tstate0["mode_state"]["Vvelocity"] + tcs.sketch_vec(spec, weighted))
        est = tcs.query_all(spec, E).abs()
        kth = torch.topk(est, K).values[-1].item()
        for i in differ:
            assert abs(est[i].item() - kth) <= 1e-5 * kth, (i, est[i].item(), kth)
    same = np.array(sorted(j_set & t_set))
    np.testing.assert_allclose(tp[same], jp[same], atol=ATOL)
    for k in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(tms[k].numpy(), np.asarray(jms[k]), atol=ATOL, err_msg=k)


def test_uncompressed_round_matches_jax(setup):
    mode_kw = dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                   error_type="none")
    d = ravel_pytree(setup[1])[0].size
    rng = np.random.RandomState(2)
    ms = {"Vvelocity": (1e-3 * rng.standard_normal(d)).astype(np.float32),
          "Verror": np.zeros(d, np.float32)}
    *_, p0, jp, tp, jms, tms = _run_both(setup, mode_kw, ms)
    assert (tp != p0).any()
    np.testing.assert_allclose(tp, jp, atol=ATOL)
    np.testing.assert_allclose(tms["Vvelocity"].numpy(), np.asarray(jms["Vvelocity"]), atol=ATOL)


def test_round_over_a_batch_without_x_or_mask(setup):
    """The cohort size comes from any leaf: an LM batch has no "x"."""
    _, _, tmodel, tparams, batch = setup
    layout = convert.FlatLayout(tmodel)
    cfg = tengine.EngineConfig(mode=TModeConfig(mode="uncompressed", d=layout.d,
                                                momentum_type="none", error_type="none"))
    step = tengine.make_round_step(tloss(tmodel, True), cfg, layout)
    state = tengine.init_server_state(cfg, layout.flatten(tparams), {})
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k != "_valid"}
    assert "x" not in tb
    new, _, m = step(state, tb, {}, LR)
    assert m["participants"].item() == W and torch.isfinite(new["params"]).all()
    with_mask, _, m2 = step(state, {**tb, "_valid": torch.ones(W)}, {}, LR)
    assert torch.equal(new["params"], with_mask["params"])


def test_dropout_seeds_are_a_function_of_the_round():
    seeds = {tengine.dropout_seed(42, r, s, i) for r in range(4) for s in range(4)
             for i in range(3)}
    assert len(seeds) == 48 and all(0 <= x < 1 << 63 for x in seeds)
    assert tengine.dropout_seed(42, 3, 1, 0) == tengine.dropout_seed(42, 3, 1, 0)
    assert tengine.dropout_seed(42, 3, 1, 0) != tengine.dropout_seed(43, 3, 1, 0)
    cfg = tengine.EngineConfig(mode=TModeConfig(mode="uncompressed", d=1, momentum_type="none",
                                                error_type="none"), seed=42)
    a, b = (cfg.generator(3, 1, 0, torch.device("cpu")) for _ in range(2))
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))


@pytest.fixture()
def flax_init(monkeypatch):
    """The port's CLI starts from the flax init of the seed, as the JAX
    CLI's does."""

    def init_from_flax(model, seed):
        cfg = dataclasses.replace(jgpt2.TINY, vocab_size=model.cfg.vocab_size,
                                  n_positions=model.cfg.n_positions)
        params = jgpt2.GPT2LMHead(cfg).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, model.cfg.n_positions), jnp.int32),
            train=False)["params"]
        tparams, _ = convert.params_from_flax(model, jax.tree.map(np.asarray, params), {})
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(tparams[name])

    monkeypatch.setattr(tg2, "init_weights", init_from_flax)


CLI = ["--model_size", "tiny", "--seq_len", str(T), "--num_clients", "12",
       "--num_workers", "2", "--local_batch_size", "2", "--lr_scale", "0.5",
       "--pivot_epoch", "0.1", "--num_rounds", "2", "--eval_every", "1",
       "--eval_batch_size", "8", "--data_root", "/nonexistent"]
ROW_KEYS = ("epoch", "lr", "train_nll", "train_ppl", "val_nll", "val_ppl", "comm_mb")


def _rows(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("mode", [["--mode", "uncompressed"],
                                  ["--mode", "sketch", "--k", "5000", "--num_cols", "8192"]])
def test_cli_matches_jax(flax_init, tmp_path, mode):
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    js = jg2.main(CLI + mode + ["--sync_loop", "--num_devices", "1", "--log_jsonl", jlog])
    ts = tg2.main(CLI + mode + ["--device", "cpu", "--log_jsonl", tlog])
    assert js.round == ts.round == 2
    jrows, trows = _rows(jlog), _rows(tlog)
    assert [r["round"] for r in trows] == [r["round"] for r in jrows] == [1, 2]
    for jr, tr in zip(jrows, trows):
        for k in ROW_KEYS:
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, err_msg=(tr, k))
        assert tr["comm_mb"] == jr["comm_mb"]
    assert trows[-1]["lr"] > 0 and trows[-1]["val_nll"] < trows[0]["val_nll"]


@pytest.fixture()
def dropout_on(monkeypatch):
    monkeypatch.setattr(tg2, "TINY", dataclasses.replace(tgpt2.TINY, dropout=0.1))


DROPOUT_CLI = CLI[:CLI.index("--num_rounds")] + [
    "--num_rounds", "4", "--eval_every", "2", "--mode", "sketch", "--k", "5000",
    "--num_cols", "8192", "--eval_batch_size", "8", "--data_root", "/nonexistent",
    "--device", "cpu"]


def _same(a, b):
    return all(torch.equal(a.state["params"] if k == "params" else a.state["mode_state"][k],
                           b.state["params"] if k == "params" else b.state["mode_state"][k])
               for k in ("params", "Vvelocity", "Verror"))


def test_dropout_async_equals_sync_and_resume(dropout_on, tmp_path):
    logs = {n: str(tmp_path / f"{n}.jsonl") for n in ("sync", "async", "resumed")}
    s = tg2.main(DROPOUT_CLI + ["--sync_loop", "--log_jsonl", logs["sync"]])
    a = tg2.main(DROPOUT_CLI + ["--rounds_per_dispatch", "2", "--log_jsonl", logs["async"]])
    assert _same(a, s)
    srows, arows = _rows(logs["sync"]), _rows(logs["async"])
    for sr, ar in zip(srows, arows):
        assert {k: v for k, v in sr.items() if k != "time_s"} == \
            {k: v for k, v in ar.items() if k != "time_s"}
    # dropout is on: two generators give two training losses on one batch
    batch = {k: torch.from_numpy(v[0]) for k, v in
             s.train_set.client_batch(np.random.RandomState(0), np.arange(1), 2).items()}
    leaves = s.layout.unflatten(s.state["params"])
    l0, l1 = (s.train_loss_fn(leaves, {}, batch, torch.Generator().manual_seed(i))[0]
              for i in range(2))
    assert l0.item() != l1.item()

    ck = ["--checkpoint_dir", str(tmp_path / "ck"), "--fault_plan", "preempt@2"]
    with pytest.raises(SystemExit) as ei:
        tg2.main(DROPOUT_CLI + ck)
    assert ei.value.code == 75
    r = tg2.main(DROPOUT_CLI + ck + ["--resume", "--log_jsonl", logs["resumed"]])
    assert r.run_stats.rounds == 1 and _same(r, s)
    assert _rows(logs["resumed"])[-1]["val_nll"] == srows[-1]["val_nll"]
    assert _rows(logs["resumed"])[-1]["comm_mb"] == srows[-1]["comm_mb"]
    state = torch.load(str(tmp_path / "ck" / "round_00000003" / "state.pt"),
                       weights_only=True)
    assert not any("gen" in k or "rng" in k for k in state)
