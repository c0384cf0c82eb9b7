"""The port's mixture of experts (``ops/moe.py``, GPT-2's ``MoEMLP``)
against the JAX package's, on the CPU, on the same numpy inputs and flax
weights:

- ``top1_dispatch`` (dispatch bitwise, combine and aux within atol 1e-5)
  and ``moe_ffn`` (within atol 1e-5) with the capacity ample (then also
  against ``dense_oracle``) and binding (the overflow tokens pass through
  bitwise); the expert products in bfloat16 held op by op, as the
  reference computes them, within half the reference's own
  bfloat16-vs-float32 gap;
- the gradient of sum(w * y) + 0.1 aux to x, the router and the experts
  against ``jax.grad`` within atol 1e-6;
- GPT-2 TINY (2 layers x n_embd 64, vocabulary 261, T = 32) with 4
  experts and its weights carried by ``params_from_flax``: forward logits
  and the layer's aux within atol 1e-5; the flat vector equals
  ``ravel_pytree``'s bitwise (leaf order, layout and d); ``make_lm_loss``
  at coef 0.01, its loss and metrics (the ``moe_aux_sum`` /
  ``moe_aux_count`` pair included) within rtol 1e-5 and its gradient
  within atol 1e-6, and at 12 layers the layers' auxes summed in the
  reference's order; the whole model in bfloat16 within half the gap;
- one FetchSGD round and one uncompressed round against the reference's
  ``make_round_step``, as ``tests/test_torch_gpt2_round.py`` holds them;
- d of GPT-2 small with 8 experts, counted on the ``meta`` device, equals
  ``jax.eval_shape``'s: 283,647,744, leaf for leaf;
- the CLI refuses ``--mc_coef`` and ``--init_from`` with ``--moe_experts``
  in the reference's words.

Within the port, bitwise, where the dense GPT-2 runs: a group of 2 gloo
ranks equals the one-process ``client_shards = 2`` emulation (state and
metrics, the aux pair included), and the ``gpt2_train`` session served in
process with the sketch payload equals its batch rounds.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

from commefficient_tpu.data.personachat import load_personachat_fed as jload
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_lm_loss as jloss
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu.ops import moe as jmoe
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_lm_loss as tloss
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.ops import moe as tmoe
from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

torch.set_num_threads(2)

T, V, B, E = 32, 261, 3, 4
COEF = 0.01
JCFG = dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T, moe_experts=E)
TCFG = dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T, moe_experts=E)
N, D = 48, 16  # tokens and width of the op-level cases


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jexpert(dt):
    def fn(p, h):
        h = h.astype(dt)
        y = jax.nn.gelu(h @ p["wi"].astype(dt), approximate=True)
        return (y @ p["wo"].astype(dt)).astype(jnp.float32)
    return fn


def _texpert(dt):
    def fn(p, h):
        h = torch.matmul(h.to(dt), p["wi"].to(dt))
        return torch.matmul(tgpt2.gelu(h), p["wo"].to(dt)).float()
    return fn


def _op_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.standard_normal((N, D)).astype(np.float32),
            "router": (0.5 * rng.standard_normal((D, E))).astype(np.float32),
            "wi": (0.2 * rng.standard_normal((E, D, 4 * D))).astype(np.float32),
            "wo": (0.1 * rng.standard_normal((E, 4 * D, D))).astype(np.float32)}


def _both(inp, capacity_factor, dt="float32"):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    jy, jaux = jmoe.moe_ffn(j["x"], j["router"], {"wi": j["wi"], "wo": j["wo"]},
                            _jexpert(jnp.dtype(dt)), capacity_factor=capacity_factor)
    ty, taux = tmoe.moe_ffn(t["x"], t["router"], {"wi": t["wi"], "wo": t["wo"]},
                            _texpert(getattr(torch, dt)), capacity_factor=capacity_factor)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), taux.item()), t


CAPACITY = {"ample": float(E), "binding": 0.5}


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_top1_dispatch_matches_reference(case):
    inp = _op_inputs(1)
    logits = inp["x"] @ inp["router"]
    C = tmoe.capacity_of(N, E, CAPACITY[case])
    assert C == max(1, int(np.ceil(CAPACITY[case] * N / E)))
    jd, jc, ja = jmoe.top1_dispatch(jnp.asarray(logits), C)
    td, tc, ta = tmoe.top1_dispatch(torch.from_numpy(logits), C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ta.item(), float(ja), atol=1e-5)
    kept = td.sum((1, 2))
    assert (kept.sum() < N) == (case == "binding")
    # each (expert, slot) holds at most one token, each token one slot
    assert td.sum(0).max() <= 1 and kept.max() <= 1


def _dense_products(t, capacity_factor, dt=torch.float32):
    """``moe_ffn`` as the reference writes it: the dense dispatch and
    combine einsums over ``top1_dispatch``'s [T, E, C] tensors."""
    C = tmoe.capacity_of(N, E, capacity_factor)
    dispatch, combine, _ = tmoe.top1_dispatch(t["x"] @ t["router"], C)
    h = torch.einsum("tec,td->ecd", dispatch, t["x"])
    y = _texpert(dt)({"wi": t["wi"], "wo": t["wo"]}, h)
    out = torch.einsum("tec,ecd->td", combine, y)
    return out + (1.0 - combine.sum((1, 2)))[:, None] * t["x"]


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_moe_ffn_matches_reference(case):
    """Within atol 1e-5 of the reference; bitwise the dense products'
    values, which the gathers compute without the [T, E, C] tensors."""
    inp = _op_inputs(2)
    (jy, jaux), (ty, taux), t = _both(inp, CAPACITY[case])
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, atol=1e-5)
    assert torch.equal(torch.from_numpy(ty), _dense_products(t, CAPACITY[case]))
    C = tmoe.capacity_of(N, E, CAPACITY[case])
    dispatch, _, _ = tmoe.top1_dispatch(t["x"] @ t["router"], C)
    dropped = dispatch.sum((1, 2)) == 0
    if case == "binding":
        assert dropped.any()
        assert torch.equal(torch.from_numpy(ty)[dropped], t["x"][dropped])
    else:
        assert not dropped.any()
        oracle = tmoe.dense_oracle(t["x"], t["router"], {"wi": t["wi"], "wo": t["wo"]},
                                   _texpert(torch.float32))
        joracle = jmoe.dense_oracle(jnp.asarray(inp["x"]), jnp.asarray(inp["router"]),
                                    {"wi": jnp.asarray(inp["wi"]), "wo": jnp.asarray(inp["wo"])},
                                    _jexpert(jnp.float32))
        np.testing.assert_allclose(oracle.numpy(), ty, atol=1e-5)
        np.testing.assert_allclose(oracle.numpy(), np.asarray(joracle), atol=1e-5)


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_moe_ffn_bf16_experts_match_reference_op_by_op(case):
    inp = _op_inputs(3)
    (jf32, _), _, _ = _both(inp, CAPACITY[case])
    with jax.disable_jit():  # the reference's bfloat16 as written, op by op
        (jbf, jaux), (tbf, taux), _ = _both(inp, CAPACITY[case], "bfloat16")
    assert tbf.dtype == np.float32
    gap, err = rel(jbf, jf32), rel(tbf, jbf)
    assert gap > 1e-3 and err <= 0.5 * gap, (err, gap)
    np.testing.assert_allclose(taux, jaux, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_moe_ffn_gradients_match_reference(case):
    inp = _op_inputs(4)
    # weights of 0.1 keep the gradients O(1), where float32 resolves 1e-6
    w = (0.1 * np.random.RandomState(5).standard_normal((N, D))).astype(np.float32)

    def jobj(x, router, wi, wo):
        y, aux = jmoe.moe_ffn(x, router, {"wi": wi, "wo": wo}, _jexpert(jnp.float32),
                              capacity_factor=CAPACITY[case])
        return jnp.sum(y * w) + 0.1 * aux

    names = ("x", "router", "wi", "wo")
    jg = jax.grad(jobj, argnums=(0, 1, 2, 3))(*(jnp.asarray(inp[k]) for k in names))
    t = {k: torch.from_numpy(inp[k]).requires_grad_(True) for k in names}
    y, aux = tmoe.moe_ffn(t["x"], t["router"], {"wi": t["wi"], "wo": t["wo"]},
                          _texpert(torch.float32), capacity_factor=CAPACITY[case])
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum() + 0.1 * aux,
                             [t[k] for k in names])
    for name, a, b in zip(names, tg, jg):
        assert a.abs().max() > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def models():
    jmodel = jgpt2.GPT2LMHead(JCFG)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32),
                         train=False)["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tgpt2.GPT2LMHead(TCFG)
    tparams, tstate = convert.params_from_flax(tmodel, params, {})
    assert tstate == {}
    return jmodel, params, tmodel, tparams


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, size=(B, T)).astype(np.int32)
    types = rng.choice([258, 259], size=(B, T)).astype(np.int32)
    return ids, types


def test_forward_logits_and_aux_match(models):
    jmodel, params, tmodel, tparams = models
    ids, types = _inputs()
    want, inter = jmodel.apply({"params": params}, ids, train=False, token_type_ids=types,
                               mutable=["intermediates"])
    auxs = []
    got = functional_call(tmodel, tparams, (torch.from_numpy(ids),),
                          {"train": False, "token_type_ids": torch.from_numpy(types),
                           "moe_aux": auxs})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    jaux = inter["intermediates"]["h_1"]["moe_mlp"]["moe_aux"]
    assert len(auxs) == len(jaux) == 1
    np.testing.assert_allclose(auxs[0].item(), float(jaux[0]), atol=1e-5)


def test_flat_layout_is_ravel_pytree(models):
    _, params, tmodel, tparams = models
    layout = convert.FlatLayout(tmodel)
    flat = layout.flatten(tparams).numpy()
    want = np.asarray(ravel_pytree(params)[0])
    assert layout.d == want.size
    np.testing.assert_array_equal(flat, want)
    names = [convert.flax_path(leaf.name) for leaf in layout.leaves]
    block = [p[1:] for p in names if p[0] == "h_1"]
    assert block[-3:] == [("moe_mlp", "router"), ("moe_mlp", "wi"), ("moe_mlp", "wo")]
    assert [p[0] for p in block].index("ln_2") < [p[0] for p in block].index("moe_mlp")
    assert all(leaf.perm is None for leaf in layout.leaves if ".moe_mlp." in leaf.name)
    back = layout.unflatten(torch.from_numpy(want.copy()))
    assert all(torch.equal(back[k], tparams[k]) for k in tparams)


def _lm_batch(seed=3):
    ids, types = _inputs(seed)
    labels = ids.copy()
    labels[:, :5] = -100
    labels[0, 20:] = -100
    labels[1] = -100
    return {"input_ids": ids, "token_type_ids": types, "labels": labels}


def _loss_and_grad(jmodel, params, tmodel, tparams, coef):
    batch = _lm_batch()
    (jl, jaux), jg = jax.value_and_grad(jloss(jmodel, train=False, moe_aux_coef=coef),
                                        has_aux=True)(
        params, {}, jax.tree.map(jnp.asarray, batch), None)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tl, taux = tloss(tmodel, train=False, moe_aux_coef=coef)(
        leaves, {}, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert set(taux["metrics"]) == set(jaux["metrics"])
    for k in jaux["metrics"]:
        np.testing.assert_allclose(taux["metrics"][k].item(), float(jaux["metrics"][k]),
                                   rtol=1e-5, err_msg=k)
    tflat = convert.FlatLayout(tmodel).flatten(dict(zip(leaves, grads))).numpy()
    np.testing.assert_allclose(tflat, np.asarray(ravel_pytree(jg)[0]), atol=1e-6)
    return taux["metrics"]


@pytest.mark.parametrize("coef", [0.0, COEF])
def test_lm_loss_and_gradient_match(models, coef):
    m = _loss_and_grad(*models, coef)
    if coef:
        assert m["moe_aux_count"].item() == 1.0 and m["moe_aux_sum"].item() > 0
    else:
        assert "moe_aux_sum" not in m


def test_twelve_layer_aux_order_matches():
    """Six MoE layers (h_1, h_3, ..., h_11): their auxes are summed in the
    reference's sorted order, and the loss, metrics and gradient match."""
    jcfg = dataclasses.replace(JCFG, n_layer=12, n_embd=32, moe_experts=2)
    jmodel = jgpt2.GPT2LMHead(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((1, T), jnp.int32), train=False)["params"])
    tmodel = tgpt2.GPT2LMHead(dataclasses.replace(TCFG, n_layer=12, n_embd=32, moe_experts=2))
    tparams, _ = convert.params_from_flax(tmodel, params, {})
    assert sum(hasattr(getattr(tmodel, f"h_{i}"), "moe_mlp") for i in range(12)) == 6
    _loss_and_grad(jmodel, params, tmodel, tparams, COEF)


def test_model_bf16_matches_reference(models):
    _, params, _, _ = models
    ids, types = _inputs(6)
    batch = _lm_batch(6)
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jgpt2.GPT2LMHead(dataclasses.replace(JCFG, dtype=dt))
        grad = jax.grad(lambda p: jloss(jm, False, COEF)(  # noqa: B023
            p, {}, jax.tree.map(jnp.asarray, batch), None)[0])
        apply = lambda p: jm.apply({"params": p}, ids, train=False,  # noqa: E731,B023
                                   token_type_ids=types)
        if dt == "float32":
            grad, apply = jax.jit(grad), jax.jit(apply)
        out[dt] = (np.asarray(apply(params)), np.asarray(ravel_pytree(grad(params))[0]))
    tm = tgpt2.GPT2LMHead(dataclasses.replace(TCFG, dtype="bfloat16"))
    tp, _ = convert.params_from_flax(tm, params, {})
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss, _ = tloss(tm, False, COEF)(tp, {}, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tp.values()))
    tg = convert.FlatLayout(tm).flatten(dict(zip(tp, grads))).numpy()
    tlog = functional_call(tm, tp, (torch.from_numpy(ids),),
                           {"train": False, "token_type_ids": torch.from_numpy(types)})
    assert tlog.dtype == torch.float32 and all(g.dtype == torch.float32 for g in grads)
    for i, got in enumerate((tlog.detach().numpy(), tg)):
        gap, err = rel(out["bfloat16"][i], out["float32"][i]), rel(got, out["bfloat16"][i])
        assert gap > 1e-3 and err <= 0.5 * gap, (i, err, gap)


W, RB, C, R, K = 2, 2, 4096, 5, 500
LR, WD, ATOL = 0.05, 5e-4, 1e-5


@pytest.fixture(scope="module")
def round_setup(models):
    jmodel, params, tmodel, tparams = models
    train, _, _ = jload("/nonexistent", 40, T, 0)
    rng = np.random.RandomState(1)
    batch = train.client_batch(rng, train.sample_clients(rng, W), RB)
    batch["_valid"] = np.ones(W, np.float32)
    return jmodel, params, tmodel, tparams, batch


def _run_both(setup, mode_kw, mode_state_np):
    jmodel, params, tmodel, tparams, batch = setup
    d = ravel_pytree(params)[0].size
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    jstate = jengine.init_server_state(jcfg, params, {})
    jstate["mode_state"] = {k: jnp.asarray(v) for k, v in mode_state_np.items()}
    jstep = jax.jit(jengine.make_round_step(jloss(jmodel, True, COEF), jcfg))
    jnew, _, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(LR),
                        jax.random.PRNGKey(0))
    layout = convert.FlatLayout(tmodel)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    tstate0 = tengine.init_server_state(tcfg, layout.flatten(tparams), {})
    tstate0["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in mode_state_np.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnew, _, tm = tengine.make_round_step(tloss(tmodel, True, COEF), tcfg, layout)(
        tstate0, tb, {}, LR)
    for k in ("loss_sum", "count", "correct", "moe_aux_sum", "moe_aux_count", "participants",
              "nonfinite_rounds"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["moe_aux_count"]) == W
    p0 = np.asarray(ravel_pytree(params)[0])
    jp = np.asarray(ravel_pytree(jnew["params"])[0])
    return layout, tcfg, tstate0, tb, p0, jp, tnew["params"].numpy(), jnew["mode_state"], \
        tnew["mode_state"]


def test_sketch_round_matches_jax(round_setup):
    from commefficient_tpu_torch.sketch import csvec as tcs

    mode_kw = dict(mode="sketch", k=K, num_rows=R, num_cols=C, seed=42, momentum=0.9,
                   momentum_type="virtual", error_type="virtual", hash_family="rotation")
    rng = np.random.RandomState(1)
    ms = {"Vvelocity": (1e-3 * rng.standard_normal((R, C))).astype(np.float32),
          "Verror": (1e-4 * rng.standard_normal((R, C))).astype(np.float32)}
    layout, tcfg, tstate0, tb, p0, jp, tp, jms, tms = _run_both(round_setup, mode_kw, ms)
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    assert len(j_set) == len(t_set) == K
    differ = j_set ^ t_set
    if differ:
        weighted, _, _ = tengine.reduce_clients(tloss(round_setup[2], True, COEF), tcfg,
                                                layout, tstate0, tb)
        spec = tcfg.mode.sketch_spec
        Et = tstate0["mode_state"]["Verror"] + LR * (
            0.9 * tstate0["mode_state"]["Vvelocity"] + tcs.sketch_vec(spec, weighted))
        est = tcs.query_all(spec, Et).abs()
        kth = torch.topk(est, K).values[-1].item()
        for i in differ:
            assert abs(est[i].item() - kth) <= 1e-5 * kth, (i, est[i].item(), kth)
    same = np.array(sorted(j_set & t_set))
    np.testing.assert_allclose(tp[same], jp[same], atol=ATOL)
    for k in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(tms[k].numpy(), np.asarray(jms[k]), atol=ATOL, err_msg=k)


def test_uncompressed_round_matches_jax(round_setup):
    mode_kw = dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                   error_type="none")
    d = ravel_pytree(round_setup[1])[0].size
    rng = np.random.RandomState(2)
    ms = {"Vvelocity": (1e-3 * rng.standard_normal(d)).astype(np.float32),
          "Verror": np.zeros(d, np.float32)}
    *_, p0, jp, tp, jms, tms = _run_both(round_setup, mode_kw, ms)
    assert (tp != p0).any()
    np.testing.assert_allclose(tp, jp, atol=ATOL)
    np.testing.assert_allclose(tms["Vvelocity"].numpy(), np.asarray(jms["Vvelocity"]), atol=ATOL)


def test_small_eight_experts_d_is_ravel_pytree():
    """GPT-2 small with 8 experts at the byte vocabulary and seq_len 256:
    the port's flat vector is the reference's, leaf for leaf, and d =
    283,647,744 (nothing allocated)."""
    jcfg = dataclasses.replace(jgpt2.SMALL, vocab_size=261, n_positions=256, moe_experts=8)
    shapes = jax.eval_shape(lambda: jgpt2.GPT2LMHead(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256), jnp.int32), train=False))["params"]
    want, offset = [], 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        want.append((tuple(p.key for p in path), tuple(leaf.shape), offset))
        offset += int(np.prod(leaf.shape))
    with torch.device("meta"):
        model = tgpt2.GPT2LMHead(dataclasses.replace(tgpt2.SMALL, vocab_size=261,
                                                     n_positions=256, moe_experts=8))
    layout = convert.FlatLayout(model)
    got = [(convert.flax_path(leaf.name), leaf.flax_shape, leaf.offset)
           for leaf in layout.leaves]
    assert layout.d == offset == 283_647_744
    assert got == want
    assert 4 * layout.d > (1 << 30)


@pytest.mark.parametrize("extra,words", [
    (["--mc_coef", "1"], "--mc_coef with --moe_experts is not supported yet"),
    (["--init_from", "/nonexistent/gpt2"],
     "--moe_experts with --init_from is not supported: HF GPT-2 checkpoints carry no "
     "expert weights"),
])
def test_cli_refuses_in_the_reference_words(extra, words):
    argv = ["--model_size", "tiny", "--seq_len", "32", "--num_clients", "8", "--device", "cpu",
            "--data_root", "/nonexistent", "--moe_experts", "4", *extra]
    with pytest.raises(SystemExit) as e:
        tg2.build(resolve_defaults(make_parser("gpt2").parse_args(argv)))
    assert str(e.value) == words


# ------------------------------------------- where the dense GPT-2 runs

GW, GROUNDS, GRANKS = 4, 2, 2  # clients, rounds and ranks of the group case
GROUP_MODE = dict(mode="sketch", k=64, num_rows=3, num_cols=4096, momentum=0.9,
                  momentum_type="virtual", error_type="virtual")


def _group_case():
    """(loss, cfg, layout, state0, batches) of the group case, the same in
    every process: TINY x 4 experts with dropout 0.1 (the MoE block's own
    dropout site included), the aux at coef 0.01, client_shards = 2."""
    model = tgpt2.GPT2LMHead(dataclasses.replace(TCFG, n_positions=16, dropout=0.1))
    tgpt2.init_weights(model, 0)
    layout = convert.FlatLayout(model)
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(GROUNDS):
        ids = rng.randint(0, V, (GW, 2, 16)).astype(np.int32)
        labels = np.where(rng.rand(GW, 2, 16) < 0.3, -100, ids).astype(np.int32)
        batches.append({"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                        "labels": labels, "_valid": np.ones(GW, np.float32)})
    cfg = tengine.EngineConfig(mode=TModeConfig(d=layout.d, **GROUP_MODE), weight_decay=5e-4,
                               seed=3, client_shards=GRANKS)
    p0 = layout.flatten({k: v.detach() for k, v in model.named_parameters()})
    return (tloss(model, train=True, moe_aux_coef=COEF), cfg, layout,
            tengine.init_server_state(cfg, p0, {}, layout), batches)


def _run_group_case(group=None, rank=0):
    """The group case's rounds: the emulation (group None, whole batches)
    or this rank's shard of a group (its slice of each batch)."""
    loss, cfg, layout, state, batches = _group_case()
    step = tengine.make_sharded_round_step(loss, cfg, layout, group)
    per = GW // GRANKS
    lo, hi = (rank * per, rank * per + per) if group is not None else (0, GW)
    metrics = []
    for b, lr in zip(batches, (0.1, 0.05)):
        state, _, m = step(state, {k: torch.from_numpy(v[lo:hi]) for k, v in b.items()}, {},
                           torch.tensor(lr))
        metrics.append(m)
    return state, metrics


def _group_rank(out_dir):
    import torch.distributed as dist

    from commefficient_tpu_torch.parallel import distributed

    distributed.initialize(force=True, device="cpu")
    rank = dist.get_rank()
    torch.save(_run_group_case(dist.group.WORLD, rank), os.path.join(out_dir, f"moe_{rank}.pt"))


def test_two_gloo_ranks_equal_the_client_shards_emulation_bitwise(tmp_path):
    """MoE on a group of 2 gloo ranks: every rank's state and metrics (the
    moe_aux_sum / moe_aux_count pair included) equal the one-process
    client_shards = 2 emulation, bitwise; the expert axis is replicated."""
    from commefficient_tpu_torch.parallel import distributed

    codes = distributed.launch_local(_group_rank, GRANKS, (str(tmp_path),), timeout_s=240)
    assert codes == [0] * GRANKS, codes
    want_state, want_metrics = _run_group_case()
    for m in want_metrics:
        assert float(m["moe_aux_count"]) == GW and float(m["moe_aux_sum"]) > 0
    for rank in range(GRANKS):
        got_state, got_metrics = torch.load(tmp_path / f"moe_{rank}.pt", weights_only=False)
        assert got_state.keys() == want_state.keys()
        assert torch.equal(got_state["params"], want_state["params"]), rank
        for k in want_state["mode_state"]:
            assert torch.equal(got_state["mode_state"][k], want_state["mode_state"][k]), (rank, k)
        for got, want in zip(got_metrics, want_metrics):
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), (rank, k)


SERVE_CLI = ["--model_size", "tiny", "--seq_len", "16", "--num_clients", "8",
             "--num_workers", "4", "--local_batch_size", "2", "--data_root", "/nonexistent",
             "--device", "cpu", "--mode", "sketch", "--k", "100", "--num_cols", "2000",
             "--moe_experts", "4", "--moe_aux_coef", "0.01"]


def test_served_sketch_rounds_equal_the_batch_rounds_bitwise():
    """The gpt2_train session with experts, served in process with the
    sketch payload (every client arriving), equals the batch rounds of the
    same flags (the per-client tables merged in the service's order)
    bitwise: state and metrics, the aux pair included."""
    from commefficient_tpu_torch.serve import clients as tclients
    from commefficient_tpu_torch.serve import service as tservice
    from commefficient_tpu_torch.serve import traffic as ttraffic

    def build(extra):
        return tg2.build(resolve_defaults(make_parser("gpt2").parse_args(SERVE_CLI + extra)))[0]

    lrs, flags = (0.1, 0.05), ["--serve", "inproc", "--serve_payload", "sketch"]
    a = build(flags)
    reliable = (tclients.DeviceClass("lab", weight=1.0, latency_median_s=0.1,
                                     latency_sigma=0.1, no_show_prob=0.0),)
    svc = tservice.AggregationService(
        a, tservice.ServeConfig(quorum=4, deadline_s=30.0, payload="sketch"),
        traffic=ttraffic.TrafficGenerator(
            ttraffic.TraceConfig(population=a.train_set.num_clients, seed=5),
            classes=reliable)).start()
    src = svc.source()
    served = []
    try:
        for lr in lrs:
            prep = src.next()
            assert 0.0 not in src.last_closed.arrived.tolist()
            served += a.commit_round(a.dispatch_round(prep, lr))
    finally:
        svc.close()
    b = build(flags)
    batch = [b.run_round(lr) for lr in lrs]
    assert torch.equal(a.state["params"], b.state["params"])
    for k in b.state["mode_state"]:
        assert torch.equal(a.state["mode_state"][k], b.state["mode_state"][k]), k
    for ms, mb in zip(served, batch):
        assert mb["moe_aux_count"] == 4 and mb["moe_aux_sum"] > 0
        for k in ("loss_sum", "count", "moe_aux_sum", "moe_aux_count", "participants"):
            assert ms[k] == mb[k], k
