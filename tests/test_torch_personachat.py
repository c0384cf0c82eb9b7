"""The port's PersonaChat data path against the JAX package's, on the CPU:

- the byte tokenizer: the same ids and special tokens;
- packing (``build_input_from_segments``, ``pack_example``): equal outputs
  on dialogs with history, persona overflow and hard truncation;
- the synthetic persona-grouped corpus at a few hundred personas: ids,
  token types, labels and every client's index list byte-equal;
- ``client_batch`` at L = 1 and L = 3 and ``eval_batches``: bitwise
  against the reference's native row sampler;
- a local ``personachat_self_original.json`` read the same way by both.
"""

import json

import numpy as np
import pytest

from commefficient_tpu.data import personachat as jpc
from commefficient_tpu.utils import tokenizer as jtokenizer
from commefficient_tpu_torch.data import personachat as tpc
from commefficient_tpu_torch.utils import tokenizer as ttokenizer

PERSONAS, SEQ_LEN, SEED = 300, 64, 7


@pytest.fixture(scope="module")
def corpora():
    jtrain, jvalid, jtok = jpc.load_personachat_fed("/nonexistent", PERSONAS, SEQ_LEN, SEED)
    ttrain, tvalid, ttok = tpc.load_personachat_fed("/nonexistent", PERSONAS, SEQ_LEN, SEED)
    assert isinstance(jtok, jtokenizer.ByteTokenizer)
    return jtrain, jvalid, ttrain, tvalid


def test_byte_tokenizer_matches():
    j, t = jtokenizer.ByteTokenizer(), ttokenizer.get_tokenizer()
    for name in ("bos_id", "eos_id", "speaker1_id", "speaker2_id", "pad_id", "vocab_size"):
        assert getattr(t, name) == getattr(j, name), name
    assert ttokenizer.SPECIAL_TOKENS == jtokenizer.SPECIAL_TOKENS
    text = "héllo, wörld! 123 ☃"
    assert t.encode(text) == j.encode(text)
    ids = t.encode(text) + [t.eos_id, t.pad_id]
    assert t.decode(ids) == j.decode(ids) == text


@pytest.mark.parametrize("seq_len", [24, 40, 200])
def test_packing_matches(seq_len):
    tok = ttokenizer.ByteTokenizer()
    persona = [tok.encode("i like red cats."), tok.encode("my dog runs fast.")]
    history = [tok.encode(s) for s in ("hi there", "how are you today?", "good, and you?")]
    reply = tok.encode("great thanks")
    for lm_labels in (True, False):
        assert (tpc.build_input_from_segments(persona, history, reply, tok, lm_labels)
                == jpc.build_input_from_segments(persona, history, reply, tok, lm_labels))
    for got, want in zip(tpc.pack_example(persona, history, reply, tok, seq_len),
                         jpc.pack_example(persona, history, reply, tok, seq_len)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_synthetic_corpus_is_byte_equal(corpora):
    jtrain, jvalid, ttrain, tvalid = corpora
    for j, t in ((jtrain, ttrain), (jvalid, tvalid)):
        assert t.seq_len == j.seq_len == SEQ_LEN
        assert t.x.dtype == j.x.dtype and t.y.dtype == j.y.dtype
        assert t.x.tobytes() == j.x.tobytes() and t.y.tobytes() == j.y.tobytes()
        assert t.num_clients == j.num_clients
        for a, b in zip(t.client_indices, j.client_indices):
            np.testing.assert_array_equal(a, b)
    assert ttrain.num_clients == PERSONAS
    # packed as the lineage packs: a labelled reply behind <bos> <speaker2>
    tok = ttokenizer.ByteTokenizer()
    assert (ttrain.x[:, 0] == tok.bos_id).all() and (ttrain.x[:, 1] == tok.speaker2_id).all()
    assert ((ttrain.y != -100).sum(axis=1) > 0).all()


@pytest.mark.parametrize("local_iters", [1, 3])
def test_client_batch_bitwise(corpora, local_iters):
    jtrain, _, ttrain, _ = corpora
    jr, tr = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        ids = jtrain.sample_clients(jr, 4)
        np.testing.assert_array_equal(ttrain.sample_clients(tr, 4), ids)
        # batch 8 is above most personas' 4-11 rows: some clients are
        # sampled, some padded with ignored rows
        jb = jtrain.client_batch(jr, ids, 8, local_iters)
        tb = ttrain.client_batch(tr, ids, 8, local_iters)
        assert sorted(tb) == sorted(jb) == ["input_ids", "labels", "token_type_ids"]
        for k in jb:
            assert tb[k].shape == jb[k].shape and tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert jr.randint(1 << 30) == tr.randint(1 << 30)


def test_eval_batches_and_decode_examples_bitwise(corpora):
    _, jvalid, _, tvalid = corpora
    jbs, tbs = list(jvalid.eval_batches(16)), list(tvalid.eval_batches(16))
    assert len(tbs) == len(jbs) > 1
    for jb, tb in zip(jbs, tbs):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    for a, b in zip(tvalid.decode_examples(5), jvalid.decode_examples(5)):
        np.testing.assert_array_equal(a, b)


def test_json_corpus_matches(tmp_path):
    dialog = {"personality": ["i have a cat.", "i love red."],
              "utterances": [{"history": ["hello"], "candidates": ["no", "hi! i like cats"]},
                             {"history": ["hello", "hi! i like cats", "what color?"],
                              "candidates": ["blue", "red, always red"]}]}
    other = {"personality": ["i run."], "utterances": [{"history": ["yo"],
                                                        "candidates": ["x", "i run daily"]}]}
    path = tmp_path / "personachat_self_original.json"
    path.write_text(json.dumps({"train": [dialog, other, dialog], "valid": [other]}))
    jt, jv, _ = jpc.load_personachat_fed(str(tmp_path), seq_len=48)
    tt, tv, _ = tpc.load_personachat_fed(str(tmp_path), seq_len=48)
    for j, t in ((jt, tt), (jv, tv)):
        assert t.x.tobytes() == j.x.tobytes() and t.y.tobytes() == j.y.tobytes()
        assert [list(c) for c in t.client_indices] == [list(c) for c in j.client_indices]
    assert tt.num_clients == 2  # grouped by persona
