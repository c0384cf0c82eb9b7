"""The port's HuggingFace GPT-2 loader (``models/gpt2_loader.py``) against
the JAX package's ``load_hf_gpt2`` and HuggingFace's own model, on the CPU.
The checkpoint is a randomly initialised tiny HF GPT-2 written by the test
(the fixture of ``tests/test_gpt2_loader.py``, at vocabulary 256 so that
the byte tokenizer's 261 grows it), as ``pytorch_model.bin`` and as
``model.safetensors``:

- the port's params equal the reference's tree carried through
  ``convert.params_from_flax``, bitwise, from either file; the grown rows
  are the mean row plus 0.02 x ``RandomState(0)`` normals, bitwise;
- the standard-library safetensors reader equals
  ``safetensors.numpy.load_file`` bitwise (F32, and F16/BF16 tensors);
- the loaded port model's logits equal HF's within rtol 1e-4, atol 2e-4
  (the reference test's tolerance), with and without token types;
- the vocabulary growth, the ``wpe`` slice and the refused shrink and
  position growth;
- ``gpt2_train.main --init_from`` runs a FetchSGD round with the mc head
  and bfloat16, from the loaded params.
"""

import json

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from commefficient_tpu.models.gpt2_loader import load_hf_gpt2 as jload
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models import gpt2_loader as tloader

torch.set_num_threads(2)

VOCAB, POS, EMBD, LAYER, HEAD = 256, 64, 64, 2, 2


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A tiny randomly initialised HF GPT-2: a directory with
    pytorch_model.bin, one with model.safetensors, and the torch model."""
    transformers = pytest.importorskip("transformers")
    from safetensors.torch import save_file

    hf_cfg = transformers.GPT2Config(
        vocab_size=VOCAB, n_positions=POS, n_embd=EMBD, n_layer=LAYER, n_head=HEAD,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg_json = json.dumps({"n_head": HEAD, "n_layer": LAYER, "n_embd": EMBD,
                           "layer_norm_epsilon": 1e-5})
    dirs = {}
    for kind in ("bin", "safetensors"):
        d = tmp_path_factory.mktemp(f"gpt2_{kind}")
        (d / "config.json").write_text(cfg_json)
        if kind == "bin":
            torch.save(model.state_dict(), d / "pytorch_model.bin")
        else:  # the tied lm_head shares wte's storage: save a copy of each
            save_file({k: v.detach().clone().contiguous() for k, v in model.state_dict().items()},
                      str(d / "model.safetensors"))
        dirs[kind] = str(d)
    return dirs, model


def _port_from_reference(path, **kw):
    """The reference's loaded tree carried into the port's names/layouts."""
    params, cfg = jload(path, **kw)
    tcfg = tgpt2.GPT2Config(vocab_size=cfg.vocab_size, n_positions=cfg.n_positions,
                            n_embd=cfg.n_embd, n_layer=cfg.n_layer, n_head=cfg.n_head,
                            ln_eps=cfg.ln_eps)
    with torch.device("meta"):
        model = tgpt2.GPT2LMHead(tcfg)
    out, _ = convert.params_from_flax(model, jax.tree.map(np.asarray, params), {})
    return out, tcfg


@pytest.mark.parametrize("kind", ["bin", "safetensors"])
@pytest.mark.parametrize("target_vocab", [None, 261])
def test_params_bitwise_equal_to_reference(hf_checkpoint, kind, target_vocab):
    dirs, _ = hf_checkpoint
    got, cfg = tloader.load_hf_gpt2(dirs[kind], target_vocab_size=target_vocab, n_positions=32)
    want, wcfg = _port_from_reference(dirs[kind], target_vocab_size=target_vocab,
                                      n_positions=32)
    assert (cfg.vocab_size, cfg.n_positions, cfg.n_embd, cfg.n_layer, cfg.n_head, cfg.ln_eps) \
        == (wcfg.vocab_size, wcfg.n_positions, wcfg.n_embd, wcfg.n_layer, wcfg.n_head,
            wcfg.ln_eps)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def test_grown_rows_follow_the_reference_formula(hf_checkpoint):
    dirs, hf = hf_checkpoint
    params, cfg = tloader.load_hf_gpt2(dirs["bin"], target_vocab_size=VOCAB + 5)
    wte = hf.transformer.wte.weight.detach().numpy()
    assert cfg.vocab_size == VOCAB + 5 and tuple(params["wte"].shape) == (VOCAB + 5, EMBD)
    np.testing.assert_array_equal(params["wte"][:VOCAB].numpy(), wte)
    rows = wte.mean(axis=0, keepdims=True) + 0.02 * np.random.RandomState(0).standard_normal(
        (5, EMBD)).astype(np.float32)
    np.testing.assert_array_equal(params["wte"][VOCAB:].numpy(), rows)


def test_stdlib_safetensors_reader_matches_library(hf_checkpoint, tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    dirs, _ = hf_checkpoint
    path = f"{dirs['safetensors']}/model.safetensors"
    got, want = tloader.read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # half-precision tensors and an empty one, through safetensors' torch writer
    mixed = {"h": torch.randn(3, 5).half(), "b": torch.randn(7).bfloat16(),
             "e": torch.zeros(0, 4)}
    save_file(mixed, str(tmp_path / "m.safetensors"))
    back = tloader.read_safetensors(str(tmp_path / "m.safetensors"))
    for k, v in mixed.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


@pytest.mark.parametrize("with_types", [False, True])
def test_logit_parity_with_hf(hf_checkpoint, with_types):
    dirs, hf = hf_checkpoint
    params, cfg = tloader.load_hf_gpt2(dirs["bin"])
    model = tgpt2.GPT2LMHead(cfg)
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, VOCAB, (2, 24)))
    tt = torch.from_numpy(rng.randint(0, VOCAB, (2, 24))) if with_types else None
    ours = functional_call(model, params, (ids,), {"train": False, "token_type_ids": tt})
    with torch.no_grad():
        theirs = hf(ids, token_type_ids=tt).logits
    np.testing.assert_allclose(ours.detach().numpy(), theirs.numpy(), rtol=1e-4, atol=2e-4)


def test_position_slice_and_errors(hf_checkpoint):
    dirs, hf = hf_checkpoint
    params, cfg = tloader.load_hf_gpt2(dirs["bin"], n_positions=16)
    assert cfg.n_positions == 16 and tuple(params["wpe"].shape) == (16, EMBD)
    assert torch.equal(params["wpe"], hf.transformer.wpe.weight.detach()[:16])
    with pytest.raises(ValueError, match="shrink"):
        tloader.load_hf_gpt2(dirs["bin"], target_vocab_size=VOCAB - 1)
    with pytest.raises(ValueError, match="extend positions"):
        tloader.load_hf_gpt2(dirs["bin"], n_positions=POS + 1)
    with pytest.raises(FileNotFoundError):
        tloader.load_hf_gpt2(str(dirs["bin"]) + "/missing")


def test_init_from_cli_round(hf_checkpoint, tmp_path, monkeypatch):
    dirs, hf = hf_checkpoint
    argv = ["--init_from", dirs["safetensors"], "--seq_len", "16", "--num_clients", "8",
            "--num_workers", "2", "--local_batch_size", "2", "--num_rounds", "2",
            "--eval_every", "2", "--eval_batch_size", "8", "--data_root", "/nonexistent",
            "--mode", "sketch", "--k", "2000", "--num_cols", "4096", "--mc_coef", "1",
            "--dtype", "bfloat16", "--device", "cpu", "--log_jsonl", str(tmp_path / "r.jsonl")]
    args = tg2.resolve_defaults(tg2.make_parser("gpt2").parse_args(argv))
    session, _, extras = tg2.build(args)
    cfg = extras["model"].cfg
    assert (cfg.vocab_size, cfg.n_positions, cfg.dtype, cfg.with_mc_head) == \
        (261, 16, "bfloat16", True)
    loaded = session.params()
    want, _ = tloader.load_hf_gpt2(dirs["bin"], target_vocab_size=261, n_positions=16)
    for k, v in want.items():
        assert torch.equal(loaded[k], v), k
    assert loaded["mc_head"].shape == (EMBD,) and 0 < loaded["mc_head"].std() < 0.05
    s = tg2.main(argv)
    rows = [json.loads(line) for line in open(tmp_path / "r.jsonl")]
    assert s.round == 2 and rows[-1]["round"] == 2
    assert all(np.isfinite(rows[-1][k]) for k in ("train_nll", "val_nll", "mc_acc"))
    assert not torch.equal(s.state["params"], session.state["params"])
