"""The port's bfloat16 compute (``--dtype bfloat16``) against the JAX
package's, on the CPU, on the same flax weights and numpy inputs.

The yardstick is the reference's own bfloat16 error: "the gap" is the
relative L2 distance of the JAX package's bfloat16 logits (or flat
gradient) from its float32 ones on the same inputs. The reference is run
op by op (eager ``apply``/``value_and_grad``, or ``jax.disable_jit``), the
semantics its source spells out and the port mirrors: every bfloat16
operation rounds its result. (Compiled, XLA keeps some intermediates in
float32: on the GPT-2 batch below the reference's jitted bfloat16 lies
0.87 (logits) and 0.94 (gradient) of the gap from its own eager bfloat16.)

- GPT-2 TINY (2 layers x n_embd 64 x 2 heads, T = 32, vocabulary 261),
  with and without the mc head: logits and gradient within half the gap
  (measured: logits 2e-7 against a gap of 6.0e-3, gradient 7.6e-4
  against 8.5e-3); logits, scores and gradients float32.
- The FEMNIST CNN, batch 4: within half the gap (measured 3.4e-5 against
  4.3e-3, 3.6e-4 against 4.3e-2).
- ResNet-9's blocks at full width, train mode (ConvBN 3 -> 64 at 32x32,
  Residual(128) at 16x16): output and gradient within half the gap
  (measured at most 1.9e-4 against 3.3e-3 and 4.2e-3 against 5.9e-2);
  the block's output bfloat16, its batch-norm statistics float32.
- ResNet-9 whole, one train-mode step at batch 4: a one-ulp difference
  in a convolution's float32 sum (the two packages add in different
  orders) flips a bfloat16 rounding, and batch norm carries the flips
  through every later layer. The reference does the same to itself: with
  prep's output channels permuted (the same function, another order of
  layer 1's sums) its logits move 0.51 and its gradient 0.58 of the gap.
  So the whole model is held to twice that self-distance and below the
  gap (measured: port 0.76 and 0.62 of the gap); its logits, gradient
  and new statistics are float32.
- One FetchSGD round of GPT-2 TINY with the mc head in bfloat16 against
  the reference's round (op by op): the same k coordinates released but
  for near-ties (agreement at least 0.99; measured 0.996), metric sums
  within 1e-3, and the new Vvelocity and Verror below the gap of the
  reference's bfloat16 round from its float32 one (measured 0.81 of it;
  rounding flips cascade through attention, as above).
- ``--dtype bfloat16`` through both CLIs on ``--device cpu``: the FEMNIST
  CNN and GPT-2 TINY with the mc head against the JAX CLIs from the same
  flax init (every row value within 2e-3 relative), and ResNet-9.
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

import cv_train as jcv
import gpt2_train as jg2
from commefficient_tpu.data import personachat as jpc
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models import femnist_cnn as jfem
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models import resnet9 as jres
from commefficient_tpu.models.losses import make_classification_loss as jcls
from commefficient_tpu.models.losses import make_lm_loss as jlm
from commefficient_tpu.models.losses import make_lm_mc_loss as jmc
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import femnist_cnn as tfem
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models import resnet9 as tres
from commefficient_tpu_torch.models.losses import make_classification_loss as tcls
from commefficient_tpu_torch.models.losses import make_lm_loss as tlm
from commefficient_tpu_torch.models.losses import make_lm_mc_loss as tmc
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig

torch.set_num_threads(2)

T, V, PAD = 32, 261, 260
DTYPES = ("float32", "bfloat16")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(tree) -> np.ndarray:
    return np.asarray(ravel_pytree(tree)[0])


def _gpt2_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (2, 2, T)).astype(np.int32)
    ids[:, :, 25:] = PAD
    types = rng.choice([258, 259], (2, 2, T)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, :5] = -100
    labels[ids == PAD] = -100
    return {"input_ids": ids, "token_type_ids": types, "labels": labels,
            "mc_label": np.array([1, 0], np.int32)}


@pytest.mark.parametrize("with_mc_head", [False, True], ids=["lm", "mc_head"])
def test_gpt2_bf16_matches_reference(with_mc_head):
    batch = _gpt2_batch()
    if not with_mc_head:  # the LM objective on the flattened candidates
        batch = {k: batch[k].reshape(4, T) for k in ("input_ids", "token_type_ids", "labels")}
    ids, types = batch["input_ids"].reshape(-1, T), batch["token_type_ids"].reshape(-1, T)
    params, out = None, {}
    for dt in DTYPES:
        jcfg = dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T,
                                   with_mc_head=with_mc_head, dtype=dt)
        jm = jgpt2.GPT2LMHead(jcfg)
        if params is None:
            params = jax.tree.map(np.asarray, jm.init(
                jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32), train=False)["params"])
        jl = jmc(jm, False, 1.0, PAD) if with_mc_head else jlm(jm, False)
        grad = jax.grad(lambda p: jl(p, {}, jax.tree.map(jnp.asarray, batch), None)[0])
        apply = lambda p: jm.apply({"params": p}, ids, train=False,  # noqa: E731
                                   token_type_ids=types)
        if dt == "float32":  # compiled float32 equals eager float32 to 1e-7
            grad, apply = jax.jit(grad), jax.jit(apply)
        out[dt] = (np.asarray(apply(params)), _flat(grad(params)))
    tm = tgpt2.GPT2LMHead(dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T,
                                              with_mc_head=with_mc_head, dtype="bfloat16"))
    tp, _ = convert.params_from_flax(tm, params, {})
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tl = (tmc(tm, False, 1.0, PAD) if with_mc_head else tlm(tm, False))
    loss, _ = tl(tp, {}, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert all(g.dtype == torch.float32 for g in grads)
    tg = convert.FlatLayout(tm).flatten(dict(zip(tp, grads))).numpy()
    tlog = functional_call(tm, tp, (torch.from_numpy(ids),),
                           {"train": False, "token_type_ids": torch.from_numpy(types)})
    assert tlog.dtype == torch.float32
    if with_mc_head:
        _, scores = functional_call(tm, tp, (torch.from_numpy(ids),),
                                    {"train": False, "mc_positions": torch.full((4,), 9)})
        assert scores.dtype == torch.float32
    for i, what in enumerate(("logits", "gradient")):
        got = tlog.detach().numpy() if i == 0 else tg
        gap = rel(out["bfloat16"][i], out["float32"][i])
        err = rel(got, out["bfloat16"][i])
        assert gap > 1e-3 and err <= 0.5 * gap, (what, err, gap)


def _classifier(jcls_model, tcls_model, shape, num_classes, seed=1):
    """(port bf16 logits, flat grad, new stats), the reference's per dtype,
    and the flax variables, for one train-mode step of batch 4."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    batch = {"x": x, "y": rng.randint(0, num_classes, shape[0]).astype(np.int32),
             "mask": np.ones(shape[0], np.float32)}
    variables, out = None, {}
    for dt in DTYPES:
        jm = jcls_model(dt)
        if variables is None:
            variables = jax.tree.map(np.asarray, jm.init(
                jax.random.PRNGKey(0), jnp.zeros((1,) + shape[1:]), train=False))
        out[dt] = _reference_step(jm, variables, batch)
    tm = tcls_model("bfloat16")
    tp, ts = convert.params_from_flax(tm, variables["params"],
                                      variables.get("batch_stats", {}))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss, aux = tcls(tm, True)(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert all(g.dtype == torch.float32 for g in grads)
    logits, _ = functional_call(tm, {**tp, **ts}, (torch.from_numpy(x),), {"train": True})
    assert logits.dtype == torch.float32
    tg = convert.FlatLayout(tm).flatten(dict(zip(tp, grads))).numpy()
    return (logits.detach().numpy(), tg, aux["net_state"]), out, variables, batch


def _reference_step(jm, variables, batch):
    """(logits, flat gradient) of one train-mode step of the JAX model, op
    by op in bfloat16 (compiled in float32, which equals eager float32 to
    1e-7)."""
    state = {"batch_stats": variables["batch_stats"]} if "batch_stats" in variables else {}
    grad = jax.grad(lambda p: jcls(jm, True)(p, state, jax.tree.map(jnp.asarray, batch),
                                             None)[0])

    def logits(p):
        full = {"params": p, **state}
        return (jm.apply(full, batch["x"], train=True, mutable=["batch_stats"])[0] if state
                else jm.apply(full, batch["x"], train=True))

    if jm.dtype == "float32":
        grad, logits = jax.jit(grad), jax.jit(logits)
    return np.asarray(logits(variables["params"])), _flat(grad(variables["params"]))


def test_femnist_bf16_matches_reference():
    (logits, grad, _), out, _, _ = _classifier(
        lambda dt: jfem.FEMNISTCNN(dtype=dt), lambda dt: tfem.FEMNISTCNN(dtype=dt),
        (4, 28, 28, 1), 62)
    for got, i in ((logits, 0), (grad, 1)):
        gap = rel(out["bfloat16"][i], out["float32"][i])
        err = rel(got, out["bfloat16"][i])
        assert gap > 1e-3 and err <= 0.5 * gap, (i, err, gap)


@pytest.mark.parametrize("block", ["convbn", "residual"])
def test_resnet9_blocks_bf16_match_reference(block):
    rng = np.random.RandomState(2)
    if block == "convbn":
        jmod, tmod, shape, cout = (lambda dt: jres.ConvBN(64, dt)), (lambda: tres.ConvBN(3, 64)), \
            (4, 32, 32, 3), 64
    else:
        jmod, tmod, shape, cout = (lambda dt: jres.Residual(128, dt)), \
            (lambda: tres.Residual(128)), (4, 16, 16, 128), 128
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape[:3] + (cout,)).astype(np.float32)
    variables, out = None, {}
    for dt in (jnp.float32, jnp.bfloat16):
        m = jmod(dt)
        if variables is None:
            variables = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                        train=False))

        def f(p, m=m, dt=dt):
            y, _ = m.apply({"params": p, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x).astype(dt), train=True, mutable=["batch_stats"])
            return (y.astype(jnp.float32) * ct).sum(), y

        (_, y), g = jax.value_and_grad(f, has_aux=True)(variables["params"])
        out[dt] = (np.asarray(y, np.float32), _flat(g))
    tm = tmod()
    tp, ts = convert.params_from_flax(tm, variables["params"], variables["batch_stats"])
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    y, stats = functional_call(tm, {**tp, **ts},
                               (torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(), True))
    assert y.dtype == torch.bfloat16 and all(s.dtype == torch.float32 for s in stats.values())
    loss = (y.float().permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum()
    grad = convert.FlatLayout(tm).flatten(
        dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))).numpy()
    for got, i in ((y.float().permute(0, 2, 3, 1).detach().numpy(), 0), (grad, 1)):
        gap = rel(out[jnp.bfloat16][i], out[jnp.float32][i])
        err = rel(got, out[jnp.bfloat16][i])
        assert gap > 1e-3 and err <= 0.5 * gap, (i, err, gap)


def _permuted_prep(variables, perm):
    """The same ResNet-9 with prep's output channels permuted (and layer 1's
    input channels to match): one function, another summation order."""
    v = jax.tree.map(np.copy, variables)
    p, s = v["params"], v["batch_stats"]
    p["ConvBN_0"]["Conv_0"]["kernel"] = p["ConvBN_0"]["Conv_0"]["kernel"][..., perm]
    for k in ("scale", "bias"):
        p["ConvBN_0"]["BatchNorm_0"][k] = p["ConvBN_0"]["BatchNorm_0"][k][perm]
    for k in ("mean", "var"):
        s["ConvBN_0"]["BatchNorm_0"][k] = s["ConvBN_0"]["BatchNorm_0"][k][perm]
    p["ConvBN_1"]["Conv_0"]["kernel"] = p["ConvBN_1"]["Conv_0"]["kernel"][:, :, perm, :]
    return v


def test_resnet9_bf16_train_step():
    (logits, grad, stats), out, variables, batch = _classifier(
        lambda dt: jres.ResNet9(dtype=dt), lambda dt: tres.ResNet9(dtype=dt), (4, 32, 32, 3), 10)
    assert all(s.dtype == torch.float32 for s in stats.values())
    perm = np.random.RandomState(5).permutation(64)
    pv = _permuted_prep(variables, perm)
    plog, pgrad_flat = _reference_step(jres.ResNet9(dtype="bfloat16"), pv, batch)
    # the permuted reference's gradient, back in the original channel order
    pgrad = jax.tree.map(np.asarray, ravel_pytree(variables["params"])[1](pgrad_flat))
    inv = np.argsort(perm)
    pgrad["ConvBN_0"]["Conv_0"]["kernel"] = pgrad["ConvBN_0"]["Conv_0"]["kernel"][..., inv]
    for k in ("scale", "bias"):
        pgrad["ConvBN_0"]["BatchNorm_0"][k] = pgrad["ConvBN_0"]["BatchNorm_0"][k][inv]
    pgrad["ConvBN_1"]["Conv_0"]["kernel"] = pgrad["ConvBN_1"]["Conv_0"]["kernel"][:, :, inv, :]
    for got, own, i in ((logits, plog, 0), (grad, _flat(pgrad), 1)):
        gap = rel(out["bfloat16"][i], out["float32"][i])
        floor = rel(own, out["bfloat16"][i])  # the reference against itself
        err = rel(got, out["bfloat16"][i])
        assert 0 < floor < gap and err < gap and err <= 2 * floor, (i, err, floor, gap)


def test_bf16_sketch_round_matches_reference():
    train, _, _ = jpc.load_personachat_fed("/nonexistent", 120, T, 7, num_candidates=2)
    W, B, C, R, K, LR, WD = 2, 2, 4096, 5, 500, 0.05, 5e-4
    rng = np.random.RandomState(1)
    batch = train.client_batch(rng, train.sample_clients(rng, W), B)
    batch["_valid"] = np.ones(W, np.float32)
    ms = {"Vvelocity": (1e-3 * rng.standard_normal((R, C))).astype(np.float32),
          "Verror": (1e-4 * rng.standard_normal((R, C))).astype(np.float32)}
    mode_kw = dict(mode="sketch", k=K, num_rows=R, num_cols=C, seed=42, momentum=0.9,
                   momentum_type="virtual", error_type="virtual", hash_family="rotation")
    params, ref = None, {}
    for dt in DTYPES:
        jm = jgpt2.GPT2LMHead(dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T,
                                                  with_mc_head=True, dtype=dt))
        if params is None:
            params = jax.tree.map(np.asarray, jm.init(
                jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32), train=False)["params"])
        d = _flat(params).size
        jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                    on_nonfinite="skip")
        state = jengine.init_server_state(jcfg, params, {})
        state["mode_state"] = {k: jnp.asarray(v) for k, v in ms.items()}
        step = jengine.make_round_step(jmc(jm, True, 1.0, PAD), jcfg)
        args = (state, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(LR),
                jax.random.PRNGKey(0))
        if dt == "float32":
            ref[dt] = jax.jit(step)(*args)
        else:
            with jax.disable_jit():  # the reference's bfloat16 as written, op by op
                ref[dt] = step(*args)
    tm = tgpt2.GPT2LMHead(dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T,
                                              with_mc_head=True, dtype="bfloat16"))
    tp, _ = convert.params_from_flax(tm, params, {})
    layout = convert.FlatLayout(tm)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=layout.d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    tstate = tengine.init_server_state(tcfg, layout.flatten(tp), {})
    tstate["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in ms.items()}
    tnew, _, tmet = tengine.make_round_step(tmc(tm, True, 1.0, PAD), tcfg, layout)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, {}, LR)
    jnew, _, jmet = ref["bfloat16"]
    for k in ("loss_sum", "count", "mc_loss_sum", "mc_count", "mc_correct", "participants"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-3, err_msg=k)
    p0 = _flat(params)
    moved_j = set(np.flatnonzero(_flat(jnew["params"]) != p0))
    moved_t = set(np.flatnonzero(tnew["params"].numpy() != p0))
    assert len(moved_t) == len(moved_j) == K and len(moved_t & moved_j) >= 0.99 * K
    for k in ("Vvelocity", "Verror"):
        gap = rel(jnew["mode_state"][k], ref["float32"][0]["mode_state"][k])
        err = rel(tnew["mode_state"][k].numpy(), jnew["mode_state"][k])
        assert err < gap, (k, err, gap)


def _rows(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture()
def flax_inits(monkeypatch):
    """Both CLIs of the port start from the flax init of the seed, as the
    JAX CLIs do."""

    def gpt2_init(model, seed):
        cfg = dataclasses.replace(jgpt2.TINY, vocab_size=model.cfg.vocab_size,
                                  n_positions=model.cfg.n_positions,
                                  with_mc_head=model.cfg.with_mc_head)
        params = jgpt2.GPT2LMHead(cfg).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, model.cfg.n_positions), jnp.int32),
            train=False)["params"]
        _copy(model, convert.params_from_flax(model, jax.tree.map(np.asarray, params), {})[0])

    def femnist_init(model, seed):
        params = jfem.FEMNISTCNN().init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)),
                                        train=False)["params"]
        _copy(model, convert.params_from_flax(model, jax.tree.map(np.asarray, params), {})[0])

    monkeypatch.setattr(tg2, "init_weights", gpt2_init)
    monkeypatch.setattr(tcv, "init_weights", femnist_init)


def _copy(model, params):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])


CV_BF16 = ["--dataset", "femnist", "--mode", "true_topk", "--k", "20000", "--num_clients", "6",
           "--num_workers", "2", "--local_batch_size", "4", "--lr_scale", "0.05",
           "--data_root", "/nonexistent", "--num_rounds", "2", "--eval_every", "1",
           "--eval_batch_size", "64", "--dtype", "bfloat16"]
GPT2_BF16 = ["--model_size", "tiny", "--seq_len", str(T), "--num_clients", "12",
             "--num_workers", "2", "--local_batch_size", "2", "--lr_scale", "0.1",
             "--pivot_epoch", "0.1", "--num_rounds", "2", "--eval_every", "1",
             "--eval_batch_size", "8", "--data_root", "/nonexistent", "--mc_coef", "1",
             "--mode", "sketch", "--k", "5000", "--num_cols", "8192", "--dtype", "bfloat16"]


@pytest.mark.parametrize("entry", ["cv_femnist", "gpt2_mc"])
def test_bf16_cli_matches_jax(flax_inits, tmp_path, entry):
    jmain, tmain, argv, keys = (
        (jcv.main, tcv.main, CV_BF16, ("train_loss", "test_loss", "test_acc", "comm_mb"))
        if entry == "cv_femnist" else
        (jg2.main, tg2.main, GPT2_BF16, ("train_nll", "val_nll", "mc_acc", "val_mc_acc",
                                         "comm_mb")))
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jmain(argv + ["--sync_loop", "--num_devices", "1", "--log_jsonl", jlog])
    ts = tmain(argv + ["--device", "cpu", "--log_jsonl", tlog])
    jrows, trows = _rows(jlog), _rows(tlog)
    assert [r["round"] for r in trows] == [r["round"] for r in jrows] == [1, 2]
    for jr, tr in zip(jrows, trows):
        for k in keys:
            np.testing.assert_allclose(tr[k], jr[k], rtol=2e-3, err_msg=(tr, k))
    assert ts.state["params"].dtype == torch.float32


def test_resnet9_cli_bf16_runs(tmp_path):
    log = str(tmp_path / "r.jsonl")
    s = tcv.main(["--device", "cpu", "--dtype", "bfloat16", "--mode", "sketch", "--num_clients",
                  "4", "--num_workers", "2", "--local_batch_size", "2", "--k", "500",
                  "--num_cols", "65536", "--num_rounds", "2", "--eval_every", "2",
                  "--synthetic_train", "16", "--eval_batch_size", "32",
                  "--data_root", "/nonexistent", "--log_jsonl", log])
    row = _rows(log)[-1]
    assert row["round"] == 2 and np.isfinite(row["train_loss"]) and np.isfinite(row["test_loss"])
    assert all(v.dtype == torch.float32 for v in s.state["net_state"].values())
    assert s.state["params"].dtype == torch.float32
