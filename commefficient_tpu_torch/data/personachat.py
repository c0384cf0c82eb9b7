"""PersonaChat federated dataset: the port's copy of the JAX package's
``data/personachat.py`` (one client per persona, about 17.5k clients), for
the LM objective and the double-head (LM plus next-utterance
classification) one.

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

For the double-head objective (``num_candidates`` > 1) every example is a
candidate set: the gold reply and C - 1 distractors, each packed as above,
with the gold one at a shuffled position (``FedTextMCDataset``).
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
                     batch_size: int, local_iters: int = 1,
                     rows: tuple[int, int] | None = None) -> dict:
        """[W, B, T] int32 per key (a [local_iters] axis after W when
        local_iters > 1), with the rows drawn as ``FedDataset.client_batch``
        draws them (``rows`` too)."""
        lo, hi = rows if rows is not None else (0, len(client_ids))
        W, L, n = hi - lo, local_iters, batch_size
        xt = np.zeros((W, L, n, self.x.shape[1]), dtype=np.int32)
        y = np.full((W, L, n, self.y.shape[1]), -100, dtype=np.int32)
        self._fill_rows(rng, client_ids, n, L, xt, y, None, lo)
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


def _pack_candidates(persona, history, gold_reply, distractor_replies, tok, seq_len: int,
                     rng: np.random.RandomState, num_candidates: int):
    """A [C, T] candidate set: C - 1 packed distractors (labels all -100)
    and the gold reply at a position drawn from ``rng``; returns (ids,
    types, labels, gold position). A short distractor list is padded with
    all-<pad> candidates."""
    packed = []
    for r in distractor_replies[:num_candidates - 1]:
        x, t, y = pack_example(persona, history, r, tok, seq_len)
        packed.append((x, t, np.full_like(y, -100)))
    pad_cand = (np.full(seq_len, tok.pad_id, np.int32), np.full(seq_len, tok.pad_id, np.int32),
                np.full(seq_len, -100, np.int32))
    while len(packed) < num_candidates - 1:
        packed.append(pad_cand)
    gold = pack_example(persona, history, gold_reply, tok, seq_len)
    pos = int(rng.randint(num_candidates))
    cands = packed[:pos] + [gold] + packed[pos:]
    return (np.stack([c[0] for c in cands]), np.stack([c[1] for c in cands]),
            np.stack([c[2] for c in cands]), pos)


class FedTextMCDataset(FedTextDataset):
    """FedTextDataset over candidate sets for the double-head objective.

    A row holds a whole set: x = [ids || types] flattened to [C*2T] and
    y = labels flattened to [C*T] with the gold index appended ([C*T + 1]),
    so one row copy moves it; batch assembly is inherited and only
    ``_unpack`` differs. Batches: {"input_ids"/"token_type_ids"/"labels":
    [W, n, C, T], "mc_label": [W, n]}, with -100 in ``mc_label`` on padded
    rows (ignored by both loss terms)."""

    def __init__(self, ids: np.ndarray, types: np.ndarray, labels: np.ndarray,
                 mc_label: np.ndarray, client_indices: list[np.ndarray]):
        N, C, T = ids.shape
        self.num_candidates = C
        x = np.concatenate([ids.reshape(N, C * T), types.reshape(N, C * T)], axis=1)
        y = np.concatenate([labels.reshape(N, C * T), mc_label[:, None].astype(np.int32)],
                           axis=1)
        FedDataset.__init__(self, x, y, client_indices)
        self.seq_len = T

    def _unpack(self, xt: np.ndarray, y: np.ndarray) -> dict:
        C, T = self.num_candidates, self.seq_len
        lead = xt.shape[:-1]
        return {"input_ids": xt[..., :C * T].reshape(lead + (C, T)),
                "token_type_ids": xt[..., C * T:].reshape(lead + (C, T)),
                "labels": y[..., :C * T].reshape(lead + (C, T)),
                "mc_label": y[..., C * T]}

    def decode_examples(self, n: int):
        """The gold candidate's row of each of the first n examples (the
        one carrying LM labels), as ``FedTextDataset.decode_examples``."""
        n = min(n, len(self.x))
        b = self._unpack(self.x[:n], self.y[:n])
        gold = np.maximum(b["mc_label"][:n], 0)
        rows = np.arange(n)
        return (b["input_ids"][rows, gold], b["token_type_ids"][rows, gold],
                b["labels"][rows, gold])


def _find_personachat_json(root: str) -> str | None:
    for name in ("personachat_self_original.json", "personachat.json"):
        for cand in (os.path.join(root, name), os.path.join(root, "personachat", name)):
            if os.path.exists(cand):
                return cand
    return None


def _from_json(path: str, tok, seq_len: int, num_candidates: int = 1, seed: int = 0):
    """The transfer-learning-conv-ai json as persona-grouped packed examples;
    the gold reply is candidates[-1]. With ``num_candidates`` > 1 each
    example is a candidate set whose distractors are drawn without
    replacement from the other candidates (a ``RandomState(seed)`` stream
    shared with the gold positions); the LM objective discards them."""
    with open(path) as f:
        blob = json.load(f)
    rng = np.random.RandomState(seed)

    def build(split):
        by_persona: dict[str, list] = {}
        for dialog in split:
            persona_sents = [tok.encode(s) for s in dialog["personality"]]
            seqs = by_persona.setdefault(" ".join(dialog["personality"]), [])
            for utt in dialog["utterances"]:
                history = [tok.encode(h) for h in utt["history"][-MAX_HISTORY_UTTERANCES:]]
                reply = tok.encode(utt["candidates"][-1])
                if num_candidates > 1:
                    distr = utt["candidates"][:-1]
                    take = min(num_candidates - 1, len(distr))
                    picks = rng.choice(len(distr), size=take, replace=False) if distr else []
                    seqs.append(_pack_candidates(
                        persona_sents, history, reply, [tok.encode(distr[i]) for i in picks],
                        tok, seq_len, rng, num_candidates))
                else:
                    seqs.append(pack_example(persona_sents, history, reply, tok, seq_len))
        return by_persona

    return build(blob["train"]), build(blob.get("valid", []))


def _synthetic(num_clients: int, seq_len: int, tok, seed: int, num_candidates: int = 1,
               hard_negatives: bool = False):
    """Persona-grouped synthetic corpus: each persona has a word-distribution
    'style' (6 favoured words), so per-client data is non-iid as in the real
    set. Examples go through the same packing; the draws come in the
    reference's order, so both packages build byte-equal corpora. The valid
    split is the last sequence of every 10th persona.

    The LM corpus (``num_candidates`` 1) draws the favoured words 70% of
    the time from the whole vocabulary. The MC corpus draws them 90% of the
    time, gives each persona a sentence "likes <its favoured words>" and
    fits every reply next to it (words dropped from the end until bos +
    persona + speaker + reply + eos fit ``seq_len``). Its distractors are
    replies in styles from the reserved upper half of the vocabulary, the
    personas' from the lower half (a signal a tiny model learns in a few
    rounds), or with ``hard_negatives`` replies in other personas' styles
    from the same full vocabulary (the real set's semantics: only matching
    the reply against the persona tells them apart)."""
    rng = np.random.RandomState(seed)
    words = ["the", "cat", "dog", "runs", "jumps", "likes", "hates", "sees",
             "red", "blue", "big", "small", "fast", "slow", "happy", "sad"]
    conc = 0.9 if num_candidates > 1 else 0.7

    def gen_text(favored):
        n_words = rng.randint(8, max(9, seq_len // 4))
        return " ".join(words[favored[rng.randint(6)]] if rng.rand() < conc
                        else words[rng.randint(len(words))] for _ in range(n_words))

    half = len(words) // 2
    pool = half if (num_candidates > 1 and not hard_negatives) else len(words)
    personas = []
    for _ in range(num_clients):
        favored = rng.choice(pool, size=6, replace=False)
        personas.append((favored, [gen_text(favored) for _ in range(rng.randint(4, 12))]))

    by_persona = {}
    for c, (favored, texts) in enumerate(personas):
        if num_candidates > 1:
            persona_sents = [tok.encode("likes " + " ".join(words[i] for i in favored))]
            reply_budget = seq_len - len(persona_sents[0]) - 3

            def fit(text):
                ws = text.split()
                enc = tok.encode(" ".join(ws))
                while ws and len(enc) > reply_budget:
                    ws = ws[:-1]
                    enc = tok.encode(" ".join(ws))
                return enc

            seqs = []
            for text in texts:
                if hard_negatives:
                    # the reference draws from the list of the other
                    # personas' indices ([c] when c is alone); a draw from
                    # its length is the same draw, without the O(clients)
                    # list per persona
                    picks = rng.choice(max(num_clients - 1, 1), size=num_candidates - 1)
                    others = [gen_text(personas[o + (o >= c) if num_clients > 1 else c][0])
                              for o in picks]
                else:
                    others = [gen_text(half + rng.choice(half, size=6, replace=False))
                              for _ in range(num_candidates - 1)]
                seqs.append(_pack_candidates(persona_sents, [], fit(text),
                                             [fit(o) for o in others], tok, seq_len, rng,
                                             num_candidates))
        else:
            seqs = [pack_example([], [], tok.encode(t), tok, seq_len) for t in texts]
        by_persona[f"persona_{c}"] = seqs
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


def _to_fed_mc(by_persona: dict) -> FedTextMCDataset:
    ids, ts, ys, mc, shards = [], [], [], [], []
    offset = 0
    for seqs in by_persona.values():
        for x, t, y, pos in seqs:
            ids.append(x)
            ts.append(t)
            ys.append(y)
            mc.append(pos)
        shards.append(np.arange(offset, offset + len(seqs)))
        offset += len(seqs)
    return FedTextMCDataset(np.stack(ids), np.stack(ts), np.stack(ys), np.asarray(mc), shards)


def _to_fed_any(by_persona: dict, num_candidates: int):
    return (_to_fed_mc if num_candidates > 1 else _to_fed)(by_persona)


@functools.lru_cache(maxsize=2)
def _synthetic_fed(num_clients: int, seq_len: int, seed: int, num_candidates: int = 1,
                   hard_negatives: bool = False):
    """The synthetic corpus as (train, valid) datasets. It is a pure
    function of its arguments and takes about 2 ms a persona (numpy's
    per-call draws), so a process that builds several sessions of one
    configuration builds it once; the datasets are only read."""
    train_p, valid_p = _synthetic(num_clients, seq_len, get_tokenizer(), seed,
                                  num_candidates, hard_negatives)
    return _to_fed_any(train_p, num_candidates), _to_fed_any(valid_p, num_candidates)


def load_personachat_fed(data_root: str = "./data", num_clients: int = 1000,
                         seq_len: int = 256, seed: int = 0, num_candidates: int = 1,
                         mc_hard_negatives: bool = False):
    """(train, valid, tokenizer), one client per persona: FedTextDatasets
    for the LM objective (``num_candidates`` 1), FedTextMCDatasets of
    candidate sets for the double-head one (``num_candidates`` > 1).
    ``mc_hard_negatives`` applies to the synthetic corpus only (the real
    set's distractors are other utterances already)."""
    tok = get_tokenizer()
    path = _find_personachat_json(data_root)
    if path is None:
        return (*_synthetic_fed(num_clients, seq_len, seed, num_candidates,
                                mc_hard_negatives), tok)
    train_p, valid_p = _from_json(path, tok, seq_len, num_candidates, seed)
    valid = valid_p if valid_p else dict(list(train_p.items())[:10])
    return _to_fed_any(train_p, num_candidates), _to_fed_any(valid, num_candidates), tok
