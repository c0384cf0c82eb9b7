"""One federated round of the port against the JAX package's round, at
full ResNet-9 width (d = 6,573,130), W = 2 clients x B = 2 rows.

Both sides get the same params, batch_stats, server state, numpy batch and
lr. The JAX side is ``engine.make_round_step`` under ``jax.jit`` on the ravel
path (its sketch runs the pure-JAX oracle on the CPU). Tolerances: new
params, Vvelocity and Verror within atol 1e-5; metric sums rtol 1e-5. The
client gradients differ at the 1e-6 level (CPU convolutions sum in another
order), so the top-k index sets must agree except where an estimate's
magnitude lies within 1e-5 (relative) of the k-th largest.

The batch comes from BATCH_SEED = 1. With seed 0, client 0's JAX gradient
differs from the port's by up to 2e-3 on some coordinates. On a batch drawn
the same way where this happened, a float64 gradient sided with the port
(within 1e-6) against JAX (4e-3 off): a ReLU or max-pool branch sat within
float32 rounding of its switch point in the JAX forward pass. A parity test
at such a point compares branch choices, not arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from commefficient_tpu_torch.models.resnet9 import ResNet9 as TResNet9
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.sketch import csvec as tcs

torch.set_num_threads(2)

W, B, C, R, K = 2, 2, 65_536, 5, 2_000
LR, WD = 0.05, 5e-4
ATOL = 1e-5
BATCH_SEED = 1


@pytest.fixture(scope="module")
def setup():
    jmodel = JResNet9(num_classes=10)
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    tmodel = TResNet9(num_classes=10)
    tparams, tstate = convert.params_from_flax(tmodel, params, stats)
    rng = np.random.RandomState(BATCH_SEED)
    batch = {
        "x": rng.standard_normal((W, B, 32, 32, 3)).astype(np.float32),
        "y": rng.randint(0, 10, size=(W, B)).astype(np.int32),
        "mask": np.array([[1, 1], [1, 0]], np.float32),
        "_valid": np.ones(W, np.float32),
    }
    return jmodel, params, stats, tmodel, tparams, tstate, batch


def _run_both(setup, mode_kw, mode_state_np):
    jmodel, params, stats, tmodel, tparams, tstate, batch = setup
    d = ravel_pytree(params)[0].size
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    jstate = jengine.init_server_state(jcfg, params, {"batch_stats": stats})
    jstate["mode_state"] = {k: jnp.asarray(v) for k, v in mode_state_np.items()}
    jstep = jax.jit(jengine.make_round_step(jloss(jmodel, True), jcfg))
    jnew, _, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(LR),
                        jax.random.PRNGKey(0))

    layout = convert.FlatLayout(tmodel)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    tstate0 = tengine.init_server_state(tcfg, layout.flatten(tparams), dict(tstate))
    tstate0["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in mode_state_np.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnew, tm = tengine.make_round_step(tloss(tmodel, True), tcfg, layout)(tstate0, tb, LR)

    p0 = np.asarray(ravel_pytree(params)[0])
    jp = np.asarray(ravel_pytree(jnew["params"])[0])
    tp = tnew["params"].numpy()
    for k in ("loss_sum", "count", "correct", "participants", "nonfinite_rounds"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for name, t in tnew["net_state"].items():
        want = convert._lookup(jnew["net_state"]["batch_stats"], convert.flax_path(name))
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    return layout, tcfg, tstate0, tb, p0, jp, tp, jnew["mode_state"], tnew["mode_state"]


def test_sketch_round_matches_jax(setup):
    mode_kw = dict(mode="sketch", k=K, num_rows=R, num_cols=C, seed=42,
                   momentum=0.9, momentum_type="virtual", error_type="virtual")
    rng = np.random.RandomState(1)
    ms = {"Vvelocity": (1e-3 * rng.standard_normal((R, C))).astype(np.float32),
          "Verror": (1e-4 * rng.standard_normal((R, C))).astype(np.float32)}
    layout, tcfg, tstate0, tb, p0, jp, tp, jms, tms = _run_both(setup, mode_kw, ms)

    # the released top-k sets: the coordinates each side's step moved
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    assert len(j_set) == len(t_set) == K
    differ = j_set ^ t_set
    if differ:
        weighted, _, _ = tengine.reduce_clients(tloss(setup[3], True), tcfg, layout,
                                                tstate0, tb)
        spec = tcfg.mode.sketch_spec
        S = tcs.sketch_vec(spec, weighted)
        E = tstate0["mode_state"]["Verror"] + LR * (0.9 * tstate0["mode_state"]["Vvelocity"] + S)
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
    d = convert.FlatLayout(setup[3]).d
    rng = np.random.RandomState(2)
    ms = {"Vvelocity": (1e-3 * rng.standard_normal(d)).astype(np.float32),
          "Verror": np.zeros(d, np.float32)}
    *_, p0, jp, tp, jms, tms = _run_both(setup, mode_kw, ms)
    np.testing.assert_allclose(tp, jp, atol=ATOL)
    np.testing.assert_allclose(tms["Vvelocity"].numpy(), np.asarray(jms["Vvelocity"]), atol=ATOL)


def test_uncompressed_rounds_equal_plain_sgd_with_momentum(setup):
    """The control: two uncompressed rounds are momentum SGD on the mean of
    the clients' gradients (weight decay added to each), computed here by
    hand from the same loss."""
    _, _, _, tmodel, tparams, tstate, batch = setup
    layout = convert.FlatLayout(tmodel)
    cfg = tengine.EngineConfig(
        mode=TModeConfig(mode="uncompressed", d=layout.d, momentum=0.9,
                         momentum_type="virtual", error_type="none"),
        weight_decay=WD)
    loss_fn = tloss(tmodel, True)
    step = tengine.make_round_step(loss_fn, cfg, layout)
    state = tengine.init_server_state(cfg, layout.flatten(tparams), dict(tstate))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = layout.flatten(tparams)
    v = torch.zeros_like(p)
    for _ in range(2):
        state, _ = step(state, tb, LR)
        grads = []
        for w in range(W):
            leaves = {k: t.clone().requires_grad_(True) for k, t in layout.unflatten(p).items()}
            loss, _ = loss_fn(leaves, tstate, {k: t[w] for k, t in tb.items() if k != "_valid"})
            g = torch.autograd.grad(loss, list(leaves.values()))
            grads.append(layout.flatten(dict(zip(leaves, g))) + WD * p)
        v = 0.9 * v + (grads[0] + grads[1]) / W
        p = p - LR * v
    np.testing.assert_allclose(state["params"].numpy(), p.numpy(), rtol=1e-5, atol=1e-6)
