"""The port's ResNet-9 against the JAX package's flax model at full width.

- The flat parameter vector must be ravel_pytree's, bitwise (the sketch
  hashes coordinate indices, so order is part of the result).
- Forward pass, loss, metric sums and the new batch_stats: rtol 1e-5 /
  atol 1e-6 (float32; the two frameworks' CPU convolutions order their sums
  differently). The logits are held to that rtol against the largest
  |logit| rather than element by element: in train mode, with batch-norm
  statistics from 4 rows, both frameworks land about 1.7e-6 from a float64
  forward pass on logits of magnitude ~1, so a logit near zero can differ
  by more than 1e-6 + 1e-5 * |logit| while both are equally right.
- The flat gradient: rtol 1e-4 / atol 1e-6, since backward convolutions
  compound that reordering over nine layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from commefficient_tpu_torch.models.resnet9 import ResNet9 as TResNet9

torch.set_num_threads(2)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _perturb_bn(tree, rng):
    """Non-trivial BatchNorm scale/bias/statistics, so the layouts of those
    leaves are exercised too (flax initialises them to 1/0)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = (1.0 + 0.1 * np.abs(rng.standard_normal(v.shape))).astype(np.float32)
        elif k in ("bias", "mean") and v.ndim == 1 and v.shape[0] != 10:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def models():
    jmodel = JResNet9(num_classes=10)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    rng = np.random.RandomState(0)
    params = _perturb_bn(jax.tree.map(np.asarray, variables["params"]), rng)
    stats = _perturb_bn(jax.tree.map(np.asarray, variables["batch_stats"]), rng)
    tmodel = TResNet9(num_classes=10)
    tparams, tstate = convert.params_from_flax(tmodel, params, stats)
    return jmodel, params, stats, tmodel, tparams, tstate


def _assert_close_to_scale(got, want, rtol, atol):
    """max |got - want| <= atol + rtol * max |want|."""
    err = np.abs(got - want).max()
    assert err <= atol + rtol * np.abs(want).max(), (err, np.abs(want).max())


def _batch(rng, b=4):
    x = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, 10, size=b).astype(np.int32)
    mask = np.ones(b, np.float32)
    mask[-1] = 0.0  # padding rows still feed the batch statistics
    return {"x": x, "y": y, "mask": mask}


def test_flat_order_is_ravel_pytree_bitwise(models):
    _, params, _, tmodel, tparams, _ = models
    want = np.asarray(ravel_pytree(params)[0])
    layout = convert.FlatLayout(tmodel)
    got = layout.flatten(tparams).numpy()
    assert layout.d == want.size == 6_573_130
    np.testing.assert_array_equal(got, want)
    back = layout.unflatten(torch.from_numpy(want.copy()))
    for name, t in tparams.items():
        assert torch.equal(back[name], t), name


@pytest.mark.parametrize("train", [True, False])
def test_forward_loss_metrics_and_stats_match_flax(models, train):
    jmodel, params, stats, tmodel, tparams, tstate = models
    batch = _batch(np.random.RandomState(1))
    jl, jaux = jloss(jmodel, train)(params, {"batch_stats": stats},
                                    jax.tree.map(jnp.asarray, batch), None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tl, taux = tloss(tmodel, train)(tparams, tstate, tb)
        tlogits, _ = torch.func.functional_call(
            tmodel, {**tparams, **tstate}, (tb["x"],), {"train": train})
    jlogits = jmodel.apply({"params": params, "batch_stats": stats}, batch["x"],
                           train=train, mutable=["batch_stats"] if train else False)
    jlogits = jlogits[0] if train else jlogits
    _assert_close_to_scale(tlogits.numpy(), np.asarray(jlogits), **FWD)
    np.testing.assert_allclose(tl.item(), float(jl), **FWD)
    for k in ("loss_sum", "count", "correct"):
        np.testing.assert_allclose(taux["metrics"][k].item(), float(jaux["metrics"][k]), **FWD)
    if train:
        jstats = jaux["net_state"]["batch_stats"]
        for name, t in taux["net_state"].items():
            want = np.asarray(convert._lookup(jstats, convert.flax_path(name)))
            np.testing.assert_allclose(t.numpy(), want, err_msg=name, **FWD)


def test_flat_gradient_matches_jax_grad(models):
    jmodel, params, stats, tmodel, tparams, tstate = models
    batch = _batch(np.random.RandomState(2))
    jf = jloss(jmodel, True)
    jgrads = jax.grad(lambda p: jf(p, {"batch_stats": stats},
                                   jax.tree.map(jnp.asarray, batch), None)[0])(params)
    want = np.asarray(ravel_pytree(jgrads)[0])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = tloss(tmodel, True)(leaves, tstate, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    layout = convert.FlatLayout(tmodel)
    got = layout.flatten(dict(zip(leaves, grads))).numpy()
    np.testing.assert_allclose(got, want, **GRAD)

