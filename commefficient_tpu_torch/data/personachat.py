"""PersonaChat federated dataset, LM objective: the port's copy of the JAX
package's ``data/personachat.py`` (one client per persona, about 17.5k
clients).

Reads the transfer-learning-conv-ai json (``personachat_self_original.json``
style: {"train": [{"personality": [...], "utterances": [{"history": [...],
"candidates": [...]}]}], "valid": [...]}) when present under ``data_root``;
clients are formed by grouping dialogs on their persona description.
Without the file a deterministic synthetic corpus with the same
persona-grouped shape is generated, draw for draw as the reference's, so
both packages train on byte-equal data from one seed.

Sequence packing follows transfer-learning-conv-ai's
``build_input_from_segments``: ``<bos> persona <speaker1/2> utt ...
<speaker2> reply <eos>`` with per-token speaker-type ids (embedded through
wte, see ``models/gpt2.py``) and LM labels only on the reply tokens. A fixed
``seq_len`` is reached by dropping the oldest history utterances first, then
truncating the persona, never the reply.

The next-utterance-classification candidates (the reference's
``FedTextMCDataset``) are not ported.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from ..utils.tokenizer import get_tokenizer
from .fed_dataset import FedDataset

MAX_HISTORY_UTTERANCES = 5  # last 2*max_history+1 with the lineage's default 2


def build_input_from_segments(persona: list[list[int]], history: list[list[int]],
                              reply: list[int], tok, lm_labels: bool = True,
                              with_eos: bool = True) -> dict:
    """Pack one dialog example the transfer-learning-conv-ai way.

    Segments: [<bos> + persona sentences], then each history utterance, then
    the reply, every post-persona segment prefixed with its speaker token,
    alternating backwards from the reply (<speaker2>); the persona is typed
    <speaker2> too. token_type_ids carry the segment's speaker id for every
    token; lm_labels are -100 everywhere but the reply tokens and its <eos>.
    Returns {"input_ids", "token_type_ids", "lm_labels", "mc_token_ids"}."""
    s1, s2 = tok.speaker1_id, tok.speaker2_id
    persona_flat = [t for sent in persona for t in sent]
    tail = list(history) + [list(reply) + ([tok.eos_id] if with_eos else [])]
    n = len(tail)
    speakers = [s2 if (n - 1 - i) % 2 == 0 else s1 for i in range(n)]
    segments = [[tok.bos_id] + persona_flat] + [[spk] + seg for spk, seg in zip(speakers, tail)]
    seg_types = [s2] + speakers
    input_ids = [t for seg in segments for t in seg]
    token_type_ids = [ty for seg, ty in zip(segments, seg_types) for _ in seg]
    labels = [-100] * len(input_ids)
    if lm_labels:
        prefix = sum(len(seg) for seg in segments[:-1])
        # the reply's speaker token is masked; reply tokens + eos are targets
        labels = [-100] * (prefix + 1) + segments[-1][1:]
    return {"input_ids": input_ids, "token_type_ids": token_type_ids, "lm_labels": labels,
            "mc_token_ids": len(input_ids) - 1}


def pack_example(persona: list[list[int]], history: list[list[int]], reply: list[int],
                 tok, seq_len: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input_ids[T], token_type_ids[T], labels[T]) at exactly seq_len: on
    overflow drop the oldest history utterance, then truncate persona tokens
    from the end, then hard-truncate the tail."""
    persona, history, reply = list(persona), list(history), list(reply)
    inst = build_input_from_segments(persona, history, reply, tok)
    while len(inst["input_ids"]) > seq_len and history:
        history = history[1:]
        inst = build_input_from_segments(persona, history, reply, tok)
    if len(inst["input_ids"]) > seq_len:
        overflow = len(inst["input_ids"]) - seq_len
        persona_len = sum(len(s) for s in persona)
        keep = max(0, persona_len - overflow)
        flat = [t for s in persona for t in s][:keep]
        inst = build_input_from_segments([flat], history, reply, tok)
    x = np.full(seq_len, tok.pad_id, dtype=np.int32)
    t = np.full(seq_len, tok.pad_id, dtype=np.int32)
    y = np.full(seq_len, -100, dtype=np.int32)
    ids = inst["input_ids"][:seq_len]
    x[:len(ids)] = ids
    t[:len(ids)] = inst["token_type_ids"][:seq_len]
    y[:len(ids)] = inst["lm_labels"][:seq_len]
    return x, t, y


class FedTextDataset(FedDataset):
    """FedDataset over packed dialog sequences. Rows hold input_ids and
    token_type_ids side by side ([N, 2T] int32), so one row copy moves both;
    batches are {"input_ids", "token_type_ids", "labels"} (labels -100 =
    ignore). A client with fewer rows than the batch is padded with
    all-ignored rows (ids 0, labels -100)."""

    def __init__(self, ids: np.ndarray, types: np.ndarray, labels: np.ndarray,
                 client_indices: list[np.ndarray]):
        self.seq_len = ids.shape[1]
        super().__init__(np.concatenate([ids, types], axis=1), labels, client_indices)

    def _unpack(self, xt: np.ndarray, y: np.ndarray) -> dict:
        T = self.seq_len
        return {"input_ids": xt[..., :T], "token_type_ids": xt[..., T:], "labels": y}

    def client_batch(self, rng: np.random.RandomState, client_ids: np.ndarray,
                     batch_size: int, local_iters: int = 1) -> dict:
        """[W, B, T] int32 per key (a [local_iters] axis after W when
        local_iters > 1), with the rows drawn as ``FedDataset.client_batch``
        draws them."""
        W, L, n = len(client_ids), local_iters, batch_size
        xt = np.zeros((W, L, n, self.x.shape[1]), dtype=np.int32)
        y = np.full((W, L, n, self.y.shape[1]), -100, dtype=np.int32)
        self._fill_rows(rng, client_ids, n, L, xt, y, None)
        batch = self._unpack(xt, y)
        if L == 1:
            batch = {k: v[:, 0] for k, v in batch.items()}
        return batch

    def eval_batches(self, batch_size: int):
        n = len(self.x)
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            xt = np.zeros((batch_size, self.x.shape[1]), dtype=np.int32)
            y = np.full((batch_size, self.y.shape[1]), -100, dtype=np.int32)
            xt[:end - start] = self.x[start:end]
            y[:end - start] = self.y[start:end]
            yield self._unpack(xt, y)

    def decode_examples(self, n: int):
        """The first n packed examples as (ids[n, T], types[n, T],
        labels[n, T]) for the generation/F1 eval: the decode prompt is ids up
        to each row's first labelled position, the gold reply the labelled
        tokens."""
        n = min(n, len(self.x))
        b = self._unpack(self.x[:n], self.y[:n])
        return b["input_ids"], b["token_type_ids"], b["labels"]


def _find_personachat_json(root: str) -> str | None:
    for name in ("personachat_self_original.json", "personachat.json"):
        for cand in (os.path.join(root, name), os.path.join(root, "personachat", name)):
            if os.path.exists(cand):
                return cand
    return None


def _from_json(path: str, tok, seq_len: int):
    """The transfer-learning-conv-ai json as persona-grouped packed examples;
    the gold reply is candidates[-1] (the distractors are not used by the LM
    objective)."""
    with open(path) as f:
        blob = json.load(f)

    def build(split):
        by_persona: dict[str, list] = {}
        for dialog in split:
            persona_sents = [tok.encode(s) for s in dialog["personality"]]
            seqs = by_persona.setdefault(" ".join(dialog["personality"]), [])
            for utt in dialog["utterances"]:
                history = [tok.encode(h) for h in utt["history"][-MAX_HISTORY_UTTERANCES:]]
                reply = tok.encode(utt["candidates"][-1])
                seqs.append(pack_example(persona_sents, history, reply, tok, seq_len))
        return by_persona

    return build(blob["train"]), build(blob.get("valid", []))


def _synthetic(num_clients: int, seq_len: int, tok, seed: int):
    """Persona-grouped synthetic corpus: each persona has a word-distribution
    'style' (6 favoured words drawn 70% of the time), so per-client data is
    non-iid as in the real set. Examples go through the same packing. The
    valid split is the last sequence of every 10th persona."""
    rng = np.random.RandomState(seed)
    words = ["the", "cat", "dog", "runs", "jumps", "likes", "hates", "sees",
             "red", "blue", "big", "small", "fast", "slow", "happy", "sad"]
    conc = 0.7

    def gen_text(favored):
        n_words = rng.randint(8, max(9, seq_len // 4))
        return " ".join(words[favored[rng.randint(6)]] if rng.rand() < conc
                        else words[rng.randint(len(words))] for _ in range(n_words))

    personas = []
    for _ in range(num_clients):
        favored = rng.choice(len(words), size=6, replace=False)
        personas.append([gen_text(favored) for _ in range(rng.randint(4, 12))])
    by_persona = {f"persona_{c}": [pack_example([], [], tok.encode(t), tok, seq_len)
                                   for t in texts]
                  for c, texts in enumerate(personas)}
    valid = {p: [s[-1]] for i, (p, s) in enumerate(by_persona.items()) if i % 10 == 0}
    return by_persona, valid


def _to_fed(by_persona: dict) -> FedTextDataset:
    xs, ts, ys, shards = [], [], [], []
    offset = 0
    for seqs in by_persona.values():
        for x, t, y in seqs:
            xs.append(x)
            ts.append(t)
            ys.append(y)
        shards.append(np.arange(offset, offset + len(seqs)))
        offset += len(seqs)
    return FedTextDataset(np.stack(xs), np.stack(ts), np.stack(ys), shards)


@functools.lru_cache(maxsize=2)
def _synthetic_fed(num_clients: int, seq_len: int, seed: int):
    """The synthetic corpus as (train, valid) FedTextDatasets. It is a pure
    function of its arguments and takes about 2 ms a persona (numpy's
    per-call draws), so a process that builds several sessions of one
    configuration builds it once; the datasets are only read."""
    train_p, valid_p = _synthetic(num_clients, seq_len, get_tokenizer(), seed)
    return _to_fed(train_p), _to_fed(valid_p)


def load_personachat_fed(data_root: str = "./data", num_clients: int = 1000,
                         seq_len: int = 256, seed: int = 0):
    """(train, valid, tokenizer) for the LM objective: FedTextDatasets of one
    client per persona."""
    tok = get_tokenizer()
    path = _find_personachat_json(data_root)
    if path is None:
        return (*_synthetic_fed(num_clients, seq_len, seed), tok)
    train_p, valid_p = _from_json(path, tok, seq_len)
    valid = valid_p if valid_p else dict(list(train_p.items())[:10])
    return _to_fed(train_p), _to_fed(valid), tok
