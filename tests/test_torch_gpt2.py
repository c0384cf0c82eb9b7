"""The port's GPT-2 against the JAX package's, on the CPU, at 2 layers x
n_embd 64 x 2 heads, T = 32, vocabulary 261, flax weights carried across by
``params_from_flax``:

- forward logits (eval) within atol 1e-5, with and without token types, and
  the ``logit_positions`` decode path;
- causality: changing token t moves no logit before t;
- ``make_lm_loss``: loss, loss_sum, count and correct within rtol 1e-5 on a
  batch with an all-ignored row and pad, and the flat gradient within
  atol 1e-6;
- ``FlatLayout`` of GPT-2 small at vocabulary 261 and T = 256: d =
  85,453,056 with ``ravel_pytree``'s leaf names, shapes and offsets (shapes
  from ``jax.eval_shape``, nothing allocated); ``wte``/``wpe`` are not
  transposed;
- the leaf permutations follow the layer kind (a raw square parameter stays
  as it is), and ResNet-9's and FEMNIST's flat vectors are still
  ``ravel_pytree``'s, bitwise;
- dropout 0.1: keep fraction within 3 sigma of 0.9, survivors scaled by
  1 / 0.9, masks a function of the generator's seed;
- greedy ``generate`` token ids equal to the reference's ``make_generate``,
  and ``word_f1`` equal on fixed strings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

from commefficient_tpu.models import generate as jgen
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_lm_loss as jloss
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import generate as tgen
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_lm_loss as tloss

torch.set_num_threads(2)

T, V, B = 32, 261, 3
JCFG = dataclasses.replace(jgpt2.TINY, vocab_size=V, n_positions=T)
TCFG = dataclasses.replace(tgpt2.TINY, vocab_size=V, n_positions=T)


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


@pytest.mark.parametrize("with_types", [False, True])
def test_forward_logits_match(models, with_types):
    jmodel, params, tmodel, tparams = models
    ids, types = _inputs()
    jt = types if with_types else None
    want = np.asarray(jmodel.apply({"params": params}, ids, train=False, token_type_ids=jt))
    got = functional_call(tmodel, tparams, (torch.from_numpy(ids),),
                          {"train": False,
                           "token_type_ids": torch.from_numpy(types) if with_types else None})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, V)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_logit_positions_path_matches(models):
    jmodel, params, tmodel, tparams = models
    ids, types = _inputs(1)
    pos = np.array([0, 17, T - 1], np.int32)
    want = np.asarray(jmodel.apply({"params": params}, ids, train=False, token_type_ids=types,
                                   logit_positions=pos))
    got = functional_call(tmodel, tparams, (torch.from_numpy(ids),),
                          {"train": False, "token_type_ids": torch.from_numpy(types),
                           "logit_positions": torch.from_numpy(pos)}).detach().numpy()
    assert got.shape == (B, V)
    np.testing.assert_allclose(got, want, atol=1e-5)
    full = functional_call(tmodel, tparams, (torch.from_numpy(ids),),
                           {"train": False, "token_type_ids": torch.from_numpy(types)})
    np.testing.assert_allclose(got, full.detach().numpy()[np.arange(B), pos], atol=1e-6)


def test_causal(models):
    *_, tmodel, tparams = models
    ids, _ = _inputs(2)
    t = 11
    changed = ids.copy()
    changed[:, t] = (changed[:, t] + 1) % V
    a, b = (functional_call(tmodel, tparams, (torch.from_numpy(x),), {"train": False})
            for x in (ids, changed))
    assert torch.equal(a[:, :t], b[:, :t])
    assert not torch.equal(a[:, t], b[:, t])


def _lm_batch(seed=3):
    ids, types = _inputs(seed)
    labels = ids.copy()
    labels[:, :5] = -100  # persona and speaker tokens
    labels[0, 20:] = -100  # pad
    labels[1] = -100  # an all-ignored (padding) row
    return {"input_ids": ids, "token_type_ids": types, "labels": labels}


def test_lm_loss_and_gradient_match(models):
    jmodel, params, tmodel, tparams = models
    batch = _lm_batch()
    (jl, jaux), jg = jax.value_and_grad(jloss(jmodel, train=False), has_aux=True)(
        params, {}, jax.tree.map(jnp.asarray, batch), None)
    layout = convert.FlatLayout(tmodel)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tl, taux = tloss(tmodel, train=False)(leaves, {}, {k: torch.from_numpy(v)
                                                       for k, v in batch.items()})
    grads = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ("loss_sum", "count", "correct"):
        np.testing.assert_allclose(taux["metrics"][k].item(), float(jaux["metrics"][k]),
                                   rtol=1e-5, err_msg=k)
    assert taux["metrics"]["count"].item() == (batch["labels"][:, 1:] != -100).sum()
    tflat = layout.flatten(dict(zip(leaves, grads))).numpy()
    np.testing.assert_allclose(tflat, np.asarray(ravel_pytree(jg)[0]), atol=1e-6)


def test_small_flat_layout_is_ravel_pytree_order():
    """GPT-2 small at the byte vocabulary and the parser's seq_len: the
    port's flat vector is the reference's, leaf for leaf."""
    jcfg = dataclasses.replace(jgpt2.SMALL, vocab_size=261, n_positions=256)
    shapes = jax.eval_shape(lambda: jgpt2.GPT2LMHead(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256), jnp.int32), train=False))["params"]
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want, offset = [], 0
    for path, leaf in paths:
        want.append((tuple(p.key for p in path), tuple(leaf.shape), offset))
        offset += int(np.prod(leaf.shape))
    with torch.device("meta"):
        model = tgpt2.GPT2LMHead(dataclasses.replace(tgpt2.SMALL, vocab_size=261,
                                                     n_positions=256))
    layout = convert.FlatLayout(model)
    got = [(convert.flax_path(leaf.name), leaf.flax_shape, leaf.offset)
           for leaf in layout.leaves]
    assert layout.d == offset == 85_453_056
    assert got == want
    names = [p for p, _, _ in got]
    assert names[:2] == [("h_0", "attn", "c_attn", "bias"), ("h_0", "attn", "c_attn", "kernel")]
    assert [p[0] for p in names].index("h_10") < [p[0] for p in names].index("h_2")
    assert names[-4:] == [("ln_f", "bias"), ("ln_f", "scale"), ("wpe",), ("wte",)]
    by_name = {leaf.name: leaf for leaf in layout.leaves}
    assert by_name["wte"].perm is None and by_name["wpe"].perm is None
    assert by_name["h_0.attn.c_attn.weight"].perm == (1, 0)


def test_leaf_permutation_follows_layer_kind(models):
    """A square raw parameter (wte at vocab == n_embd) is carried as it is;
    a square linear weight is transposed."""
    cfg = dataclasses.replace(TCFG, vocab_size=64)
    jcfg = dataclasses.replace(JCFG, vocab_size=64)
    params = jax.tree.map(np.asarray, jgpt2.GPT2LMHead(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, T), jnp.int32), train=False)["params"])
    model = tgpt2.GPT2LMHead(cfg)
    tparams, _ = convert.params_from_flax(model, params, {})
    np.testing.assert_array_equal(tparams["wte"].numpy(), params["wte"])
    kernel = params["h_0"]["attn"]["c_proj"]["kernel"]
    assert kernel.shape == (64, 64)
    np.testing.assert_array_equal(tparams["h_0.attn.c_proj.weight"].numpy(), kernel.T)
    layout = convert.FlatLayout(model)
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(),
                                  np.asarray(ravel_pytree(params)[0]))


@pytest.mark.parametrize("which", ["resnet9", "femnist"])
def test_cv_flat_vectors_unchanged(which):
    """ResNet-9 and the FEMNIST CNN: the flat vector of the carried weights
    is ravel_pytree's, bitwise, and back."""
    if which == "resnet9":
        from commefficient_tpu.models.resnet9 import ResNet9 as J
        from commefficient_tpu_torch.models.resnet9 import ResNet9 as Tm
        x = jnp.zeros((1, 32, 32, 3))
    else:
        from commefficient_tpu.models.femnist_cnn import FEMNISTCNN as J
        from commefficient_tpu_torch.models.femnist_cnn import FEMNISTCNN as Tm
        x = jnp.zeros((1, 28, 28, 1))
    variables = J().init(jax.random.PRNGKey(2), x, train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    model = Tm()
    tparams, _ = convert.params_from_flax(model, params, stats)
    layout = convert.FlatLayout(model)
    flat = np.asarray(ravel_pytree(params)[0])
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(), flat)
    for k, v in layout.unflatten(torch.from_numpy(flat.copy())).items():
        assert torch.equal(v, tparams[k]), k
    for leaf in layout.leaves:
        assert leaf.perm == ((2, 3, 1, 0) if len(leaf.shape) == 4 else
                             (1, 0) if len(leaf.shape) == 2 else None), leaf.name


def test_dropout_statistics_and_determinism():
    n, rate = 200_000, 0.1
    x = torch.ones(n)
    out = tgpt2.dropout(x, rate, torch.Generator().manual_seed(0))
    kept = out != 0
    frac = kept.float().mean().item()
    sigma = (0.9 * 0.1 / n) ** 0.5
    assert abs(frac - 0.9) < 3 * sigma, frac
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 1.0 / 0.9))
    again = tgpt2.dropout(x, rate, torch.Generator().manual_seed(0))
    other = tgpt2.dropout(x, rate, torch.Generator().manual_seed(1))
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert tgpt2.dropout(x, rate, None) is x


def test_training_forward_draws_from_its_generator(models):
    *_, tparams = models
    model = tgpt2.GPT2LMHead(dataclasses.replace(TCFG, dropout=0.1))
    ids = torch.from_numpy(_inputs(4)[0])

    def fwd(seed, train=True):
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        return functional_call(model, tparams, (ids,), {"train": train, "gen": gen})

    assert torch.equal(fwd(5), fwd(5)) and not torch.equal(fwd(5), fwd(6))
    assert torch.equal(fwd(5, train=False), fwd(None, train=False))
    with pytest.raises(ValueError, match="generator"):
        fwd(None)


@pytest.mark.parametrize("field,value", [("attn_impl", "ring"), ("moe_experts", 4),
                                         ("remat", True)])
def test_unported_configs_raise(field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        tgpt2.GPT2LMHead(dataclasses.replace(TCFG, **{field: value}))


def test_greedy_generate_matches(models):
    jmodel, params, tmodel, tparams = models
    ids, types = _inputs(5)
    prompt_len = np.array([4, 10, 29], np.int32)
    tail = np.arange(T)[None] >= prompt_len[:, None]
    ids, types = np.where(tail, 260, ids), np.where(tail, 260, types)
    kw = dict(eos_id=257, pad_id=260, reply_type_id=259, max_new=6, temperature=0.0)
    jout, jlen = jgen.make_generate(jmodel, **kw)(
        params, jnp.asarray(ids), jnp.asarray(types), jnp.asarray(prompt_len),
        jax.random.PRNGKey(0))
    tout, tlen = tgen.make_generate(tmodel, **kw)(
        tparams, torch.from_numpy(ids), torch.from_numpy(types), torch.from_numpy(prompt_len))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    # the row at 29 runs off the buffer after 3 tokens
    assert tlen[2].item() <= T


def test_nucleus_sampling_is_a_draw_from_the_nucleus():
    logits = torch.tensor([[5.0, 4.0, -3.0, -9.0], [0.0, 0.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    picks = torch.stack([tgen._nucleus_pick(logits, gen, 1.0, 0.9) for _ in range(400)])
    # row 0: the nucleus at top_p 0.9 is {0, 1}; row 1: the first 4 * 0.9 -> all 4
    assert set(picks[:, 0].tolist()) == {0, 1}
    assert set(picks[:, 1].tolist()) == {0, 1, 2, 3}
    again = torch.Generator().manual_seed(0)
    assert torch.equal(picks[0], tgen._nucleus_pick(logits, again, 1.0, 0.9))


@pytest.mark.parametrize("pred,gold", [
    ("I like red cats!", "i like RED dogs."), ("", ""), ("", "hello"),
    ("the the cat", "the cat cat"), ("Blue, blue; sky.", "green grass"),
])
def test_word_f1_matches(pred, gold):
    assert tgen.word_f1(pred, gold) == jgen.word_f1(pred, gold)


def test_port_imports_no_transformers():
    """The GPU machine has no ``transformers``: no module of the port (nor
    chip_smoke.py) imports it."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "commefficient_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "transformers" for n in names), path
