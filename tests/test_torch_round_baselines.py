"""One round of each baseline mode through the port's ``make_round_step``
against the JAX package's, at full ResNet-9 width (d = 6,573,130) and at
full FEMNIST CNN width (d = 6,603,710; its cases run in
tests/test_torch_femnist.py), W = 2 clients x B = 2 rows.

Both sides get the same params, statistics, server state, client rows,
numpy batch and lr; the JAX side runs ``engine.make_round_step`` under
``jax.jit`` (its per-client branch vmaps the clients). Tolerances, as in
tests/test_torch_round.py: new params, server state and client rows within
atol 1e-5, batch-norm statistics rtol 1e-5, metric sums rtol 1e-5 (the
clients' gradients differ at the 1e-6 level: the two packages' CPU
convolutions sum in different orders). A top-k may then swap a coordinate
whose magnitude lies within 1e-5 (relative) of the k-th largest; every
other coordinate must agree.

The batch is drawn as tests/test_torch_round.py draws its parity batch
(BATCH_SEED = 1, one padded row); fedavg/localSGD draw [W, L, B]
microbatches the same way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models.femnist_cnn import FEMNISTCNN as JFEMNIST
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.femnist_cnn import FEMNISTCNN as TFEMNIST
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from commefficient_tpu_torch.models.resnet9 import ResNet9 as TResNet9
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.sketch import csvec

torch.set_num_threads(2)

W, B, L, K = 2, 2, 2, 2_000
LR, WD = 0.05, 5e-4
ATOL = 1e-5
NEAR_TIE = 1e-5
BATCH_SEED = 1


@functools.lru_cache(maxsize=1)
def _model(name: str):
    """(jax model, params, batch_stats, torch model, params, statistics,
    image shape, classes)."""
    if name == "resnet9":
        jmodel, tmodel, shape, classes = JResNet9(num_classes=10), TResNet9(10), (32, 32, 3), 10
    else:
        jmodel, tmodel, shape, classes = JFEMNIST(), TFEMNIST(), (28, 28, 1), 62
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, *shape)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, dict(variables.get("batch_stats", {})))
    tparams, tstate = convert.params_from_flax(tmodel, params, stats)
    return jmodel, params, stats, tmodel, tparams, tstate, shape, classes


def _batch(shape, classes, local_iters):
    rng = np.random.RandomState(BATCH_SEED)
    lead = (W, local_iters, B) if local_iters > 1 else (W, B)
    mask = np.ones(lead, np.float32)
    mask[1, ..., 1] = 0.0  # a padded row
    return {"x": rng.standard_normal(lead + shape).astype(np.float32),
            "y": rng.randint(0, classes, size=lead).astype(np.int32),
            "mask": mask, "_valid": np.ones(W, np.float32)}


MODES = {
    "true_topk": dict(mode="true_topk", k=K, momentum_type="virtual", error_type="virtual"),
    "true_topk_sketch_state": dict(mode="true_topk", k=K, momentum_type="virtual",
                                   error_type="virtual", server_state="sketch", num_rows=5,
                                   num_cols=65_536, hash_family="rotation"),
    "local_topk": dict(mode="local_topk", k=K, momentum_type="local", error_type="local",
                       num_clients=5),
    "local_topk_virtual": dict(mode="local_topk", k=K, momentum_type="virtual",
                               error_type="virtual"),
    "fedavg": dict(mode="fedavg", momentum_type="virtual", error_type="none",
                   num_local_iters=L),
    "localSGD": dict(mode="localSGD", momentum_type="local", error_type="none",
                     num_local_iters=L, server_lr=0.5),
}


def _kth_check(est_abs: np.ndarray, coords, k: int, what: str):
    kth = np.partition(est_abs, -k)[-k]
    for i in coords:
        assert abs(est_abs[i] - kth) <= NEAR_TIE * kth, (what, i, est_abs[i], kth)


def _run_both(name: str, mode_kw: dict):
    jmodel, params, stats, tmodel, tparams, tstate, shape, classes = _model(name)
    d = ravel_pytree(params)[0].size
    mcfg = TModeConfig(d=d, **mode_kw)
    batch = _batch(shape, classes, mcfg.num_local_iters)
    rng = np.random.RandomState(2)
    mshape = tmodes.init_server_state(mcfg, "cpu")["Vvelocity"].shape
    ms = {"Vvelocity": (1e-3 * rng.standard_normal(mshape)).astype(np.float32),
          "Verror": (1e-4 * rng.standard_normal(mshape)).astype(np.float32)}
    cstate = tmodes.init_client_state(mcfg) or {}
    rows = {k: (0.3 * rng.standard_normal((W, d))).astype(np.float32) for k in cstate}

    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=WD,
                                on_nonfinite="skip")
    jnet = {"batch_stats": stats} if stats else {}
    jstate = jengine.init_server_state(jcfg, params, jnet)
    jstate["mode_state"] = {k: jnp.asarray(v) for k, v in ms.items()}
    jstep = jax.jit(jengine.make_round_step(jloss(jmodel, True), jcfg))
    jnew, jrows, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                            {k: jnp.asarray(v) for k, v in rows.items()}, jnp.float32(LR),
                            jax.random.PRNGKey(0))

    layout = convert.FlatLayout(tmodel)
    tcfg = tengine.EngineConfig(mode=mcfg, weight_decay=WD, on_nonfinite="skip")
    tstate0 = tengine.init_server_state(tcfg, layout.flatten(tparams), dict(tstate))
    tstate0["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in ms.items()}
    tstep = tengine.make_round_step(tloss(tmodel, True), tcfg, layout)
    tnew, trows, tm = tstep(tstate0, {k: torch.from_numpy(v) for k, v in batch.items()},
                            {k: torch.from_numpy(v.copy()) for k, v in rows.items()}, LR)

    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for tname, t in tnew["net_state"].items():
        want = convert._lookup(jnew["net_state"]["batch_stats"], convert.flax_path(tname))
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=tname)
    p0 = np.asarray(ravel_pytree(params)[0])
    jp = np.asarray(ravel_pytree(jnew["params"])[0])
    tp = tnew["params"].numpy()
    jms = {k: np.asarray(v) for k, v in jnew["mode_state"].items()}
    tms = {k: v.numpy() for k, v in tnew["mode_state"].items()}
    jr = {k: np.asarray(v) for k, v in jrows.items()}
    tr = {k: v.numpy() for k, v in trows.items()}
    assert tr.keys() == jr.keys() == rows.keys()
    return mcfg, p0, (jp, tp), (jms, tms), (jr, tr), rows


def check_round(name: str, mode: str):
    """One round of ``MODES[mode]`` on model ``name`` ("resnet9" or
    "femnist") in both packages, held at the tolerances above."""
    mcfg, p0, (jp, tp), (jms, tms), (jr, tr), rows = _run_both(name, MODES[mode])
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    sparse_release = mcfg.mode == "true_topk" or (mcfg.mode == "local_topk"
                                                  and mcfg.error_type == "virtual")
    if sparse_release:
        assert len(t_set) <= K and len(j_set) <= K and len(t_set) > 0.99 * K
        differ = sorted(j_set ^ t_set)
        assert len(differ) <= 0.01 * K
        delta = torch.from_numpy(np.where(tp != p0, p0 - tp, 0.0).astype(np.float32))
        keep = np.ones(tms["Verror"].shape, bool)
        if mcfg.server_state == "dense":
            # the error before the release: E = Verror' + delta
            est = np.abs(tms["Verror"] + delta.numpy())
            keep[differ] = False
        else:
            # in sketch space: E = Verror' + sketch(delta); the buckets a
            # swapped coordinate lands in differ between the two sides
            spec = mcfg.sketch_spec
            E = torch.from_numpy(tms["Verror"]) + csvec.sketch_vec(spec, delta)
            est = np.abs(csvec.query_all(spec, E).numpy())
            if differ:
                buckets, _ = csvec._block_hashes(spec, torch.tensor(differ), torch.float32)
                for r in range(spec.r):
                    keep[r, buckets[r].numpy()] = False
        _kth_check(est, differ, K, "server top-k")
        same = np.array(sorted(j_set & t_set))
        np.testing.assert_allclose(tp[same], jp[same], atol=ATOL)
        for k in tms:
            np.testing.assert_allclose(tms[k][keep], jms[k][keep], atol=ATOL, err_msg=k)
    else:
        np.testing.assert_allclose(tp, jp, atol=ATOL)
        for k in tms:
            np.testing.assert_allclose(tms[k], jms[k], atol=ATOL, err_msg=k)
    for k in tr:
        # the clients' own top-k: a swapped near-tie moves a row entry
        # between 0 and u_i, where |u_i| is the client's k-th |u|
        for w in range(W):
            bad = np.flatnonzero(np.abs(tr[k][w] - jr[k][w]) > ATOL)
            assert len(bad) <= 2, (k, w, bad)
            if len(bad) and k == "error":
                kth = np.abs(tr[k][w]).max()
                for i in bad:
                    v = max(abs(tr[k][w][i]), abs(jr[k][w][i]))
                    assert abs(v - kth) <= 1e-4 * kth, (k, w, i, v, kth)
    if rows:
        # rows moved: every client took part
        assert all(not np.array_equal(tr[k], rows[k]) for k in tr)


@pytest.mark.parametrize("mode", list(MODES))
def test_round_matches_jax(mode):
    check_round("resnet9", mode)
