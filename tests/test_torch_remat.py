"""Rematerialisation of GPT-2's blocks (``GPT2Config.remat``, the
reference's ``nn.remat(Block)``): each block's forward is recomputed in the
backward (``models/gpt2.py::_Remat``), and the results are bitwise the
plain model's, in float32 and bfloat16, with and without the mixture of
experts, with dropout drawn from a generator or read from masks, by plain
autograd and under the engine's ``vmap(grad(...))``; and the remat
gradients agree with the reference's remat gradients within
tests/test_torch_gpt2.py's atol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_lm_loss as jloss
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_lm_loss as tloss
from commefficient_tpu_torch.modes.config import ModeConfig

torch.set_num_threads(2)
T, V, W = 16, 261, 3


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (W, 2, T)).astype(np.int64)
    return {"input_ids": torch.from_numpy(ids),
            "labels": torch.from_numpy(np.where(rng.rand(W, 2, T) < 0.3, -100, ids))}


def _run(remat, dtype, moe):
    """(client updates and metric sums through the engine, plain autograd's
    loss and flat gradient with a generator) of one configuration."""
    cfg = dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T, dropout=0.1,
                              remat=remat, moe_experts=moe, dtype=dtype)
    model = tgpt2.GPT2LMHead(cfg)
    tgpt2.init_weights(model, 0)
    layout = convert.FlatLayout(model)
    loss = tloss(model, True, moe_aux_coef=0.01 if moe else 0.0)
    p = layout.flatten({k: v.detach() for k, v in model.named_parameters()})
    ecfg = engine.EngineConfig(mode=ModeConfig(mode="uncompressed", d=layout.d,
                                               momentum_type="none", error_type="none"),
                               weight_decay=5e-4)
    batch = _batch()
    upd, _, met = engine.make_client_updates(loss, ecfg, layout)(
        {"params": p, "net_state": {}, "round": 0}, batch, 0.1, range(W))
    leaves = {k: v.clone().requires_grad_(True) for k, v in layout.unflatten(p).items()}
    one = {k: v[0] for k, v in batch.items()}
    val, _ = loss(leaves, {}, one, torch.Generator().manual_seed(5))
    grads = torch.autograd.grad(val, list(leaves.values()))
    return upd, met, val.detach(), layout.flatten(dict(zip(leaves, grads)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moe", [0, 4])
def test_remat_equals_plain_bitwise(dtype, moe):
    plain, remat = _run(False, dtype, moe), _run(True, dtype, moe)
    assert torch.equal(plain[0], remat[0])
    for k in plain[1]:
        assert torch.equal(plain[1][k], remat[1][k]), k
    assert torch.equal(plain[2], remat[2]) and torch.equal(plain[3], remat[3])


def test_remat_gradients_match_reference_remat():
    """The reference's remat model and the port's on the same flax weights
    and batch (dropout 0): loss and gradient."""
    jcfg = dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T, remat=True)
    jmodel = jgpt2.GPT2LMHead(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32), train=False)["params"])
    b = {k: v[0].numpy().astype(np.int32) for k, v in _batch(2).items()}
    (jl, _), jg = jax.value_and_grad(jloss(jmodel, train=True), has_aux=True)(
        params, {}, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(0))
    tmodel = tgpt2.GPT2LMHead(dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T,
                                                  remat=True))
    tparams, _ = convert.params_from_flax(tmodel, params, {})
    layout = convert.FlatLayout(tmodel)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tl, _ = tloss(tmodel, True)(leaves, {}, {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(layout.flatten(dict(zip(leaves, grads))).numpy(),
                               np.asarray(ravel_pytree(jg)[0]), atol=1e-6)
