"""The port's FEMNIST slice against the JAX package's, on the CPU: the CNN's
forward and gradient at converted weights, its flat order, the synthetic
LEAF-shaped writers, batch assembly with local iterations, and one round of
every mode at full width (d = 6,603,710).

- forward logits within atol 1e-5 and the flat gradient within atol 1e-6
  (the CPU convolutions of the two packages sum in different orders);
- ``FlatLayout`` = ``ravel_pytree``: bitwise, both ways;
- synthetic writers and their train/test split: bitwise;
- ``client_batch(..., local_iters=3)``: bitwise against the reference's
  native sampler (one splitmix64 stream per (slot, iteration));
- rounds: tests/test_torch_round_baselines.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

from commefficient_tpu.data.cifar import load_cifar_fed as jload_cifar
from commefficient_tpu.data.femnist import load_femnist_fed as jload
from commefficient_tpu.models.femnist_cnn import FEMNISTCNN as JFEMNIST
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu_torch.data.cifar import load_cifar_fed as tload_cifar
from commefficient_tpu_torch.data.femnist import load_femnist_fed as tload
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.femnist_cnn import FEMNISTCNN as TFEMNIST
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from test_torch_round_baselines import MODES, check_round

torch.set_num_threads(2)


def _converted(seed=0):
    jmodel, tmodel = JFEMNIST(), TFEMNIST()
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed),
                                                  jnp.zeros((1, 28, 28, 1)))["params"])
    tparams, tstate = convert.params_from_flax(tmodel, params, {})
    return jmodel, params, tmodel, tparams, tstate


def test_flat_layout_is_ravel_pytree_order():
    _, params, tmodel, tparams, tstate = _converted()
    layout = convert.FlatLayout(tmodel)
    flat = np.asarray(ravel_pytree(params)[0])
    assert layout.d == flat.size == 6_603_710 and tstate == {}
    assert [convert.flax_path(leaf.name) for leaf in layout.leaves] == [
        ("Conv_0", "bias"), ("Conv_0", "kernel"), ("Conv_1", "bias"), ("Conv_1", "kernel"),
        ("Dense_0", "bias"), ("Dense_0", "kernel"), ("Dense_1", "bias"), ("Dense_1", "kernel")]
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(), flat)
    back = layout.unflatten(torch.from_numpy(flat.copy()))
    for k, v in back.items():
        assert torch.equal(v, tparams[k]), k


def test_forward_and_gradient_match_jax():
    jmodel, params, tmodel, tparams, _ = _converted(1)
    rng = np.random.RandomState(0)
    batch = {"x": rng.standard_normal((4, 28, 28, 1)).astype(np.float32),
             "y": rng.randint(0, 62, 4).astype(np.int32),
             "mask": np.array([1, 1, 1, 0], np.float32)}
    jl = np.asarray(jmodel.apply({"params": params}, jnp.asarray(batch["x"]), train=False))
    tl, stats = functional_call(tmodel, tparams, (torch.from_numpy(batch["x"]),))
    assert stats == {}
    np.testing.assert_allclose(tl.detach().numpy(), jl, atol=1e-5)

    def jf(p):
        return jloss(jmodel, True)(p, {}, jax.tree.map(jnp.asarray, batch),
                                   jax.random.PRNGKey(0))
    (jloss_v, _), jg = jax.value_and_grad(jf, has_aux=True)(params)
    layout = convert.FlatLayout(tmodel)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    loss, aux = tloss(tmodel, True)(leaves, {}, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    assert aux["net_state"] == {}
    np.testing.assert_allclose(loss.item(), float(jloss_v), rtol=1e-6)
    g = torch.autograd.grad(loss, list(leaves.values()))
    tg = layout.flatten(dict(zip(leaves, g))).numpy()
    np.testing.assert_allclose(tg, np.asarray(ravel_pytree(jg)[0]), atol=1e-6)


@pytest.mark.parametrize("clients,seed", [(40, 0), (7, 3)])
def test_synthetic_writers_bitwise(clients, seed):
    jtr, jte, jn = jload("/nonexistent", clients, seed)
    ttr, tte, tn = tload("/nonexistent", clients, seed)
    assert jn == tn == 62
    for j, t in ((jtr, ttr), (jte, tte)):
        np.testing.assert_array_equal(t.x, j.x)
        np.testing.assert_array_equal(t.y, j.y)
        assert len(t.client_indices) == len(j.client_indices)
        for a, b in zip(t.client_indices, j.client_indices):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("local_iters,batch", [(3, 8), (3, 40), (2, 4)])
def test_client_batch_with_local_iters_matches_native_sampler(local_iters, batch):
    """Cohorts and [W, L, B] batches of three rounds, bitwise: FEMNIST's
    writers (10-40 rows each) and synthetic CIFAR shards."""
    sets = [(jload("/nonexistent", 30, 1)[0], tload("/nonexistent", 30, 1)[0]),
            (jload_cifar("cifar10", 8, False, "/nonexistent", 42, synthetic_train=64,
                         synthetic_test=8)[0],
             tload_cifar("cifar10", 8, False, "/nonexistent", 42, synthetic_train=64,
                         synthetic_test=8)[0])]
    for jset, tset in sets:
        rj, rt = np.random.RandomState(5), np.random.RandomState(5)
        for _ in range(3):
            ij, it = jset.sample_clients(rj, 6), tset.sample_clients(rt, 6)
            np.testing.assert_array_equal(ij, it)
            bj = jset.client_batch(rj, ij, batch, local_iters)
            bt = tset.client_batch(rt, it, batch, local_iters)
            assert bj.keys() == bt.keys()
            for k in bj:
                assert bt[k].shape[:3] == (6, local_iters, batch)
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_femnist_round_matches_jax(mode):
    check_round("femnist", mode)
