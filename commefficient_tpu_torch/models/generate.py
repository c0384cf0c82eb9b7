"""Autoregressive decoding for the PersonaChat eval: the port's twin of the
JAX package's ``models/generate.py``.

The decode loop runs a fixed number of steps on a fixed [B, T] token buffer:
each step runs a forward over the whole buffer and reads the logits at every
row's own current position (the model's ``logit_positions`` fast path);
positions past a finished row (<eos> emitted) keep <pad>. There is no KV
cache, as in the reference: eval decodes a handful of examples. The model
may compute in bfloat16 (its logits are float32 either way) and may carry
the mc head, which a forward without ``mc_positions`` leaves out; an MC
dataset hands the decoder its gold candidates (``decode_examples``).

Temperature 0 is greedy (argmax, the lowest index on ties, as
``jnp.argmax``). Otherwise nucleus (top-p) sampling in sorted-logit space
from an explicit ``torch.Generator`` on the CPU: the [B, V] logits of a step
come to the host, because the cumulative sum it needs has no deterministic
CUDA kernel (``torch.use_deterministic_algorithms`` raises on it). The
samples differ from the reference's (threefry is not ported); only their
distribution matches.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch


def _nucleus_pick(logits: torch.Tensor, gen: torch.Generator | None, temperature: float,
                  top_p: float) -> torch.Tensor:
    """[B, V] logits -> [B] token ids: greedy at temperature 0, else a draw
    from the smallest prefix of the sorted distribution whose preceding
    mass is below top_p (the mode always survives)."""
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = logits.float().cpu() / temperature
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = probs.cumsum(-1)
    filtered = torch.where(cum - probs < top_p, sorted_logits,
                           torch.full_like(sorted_logits, -float("inf")))
    pick = torch.multinomial(torch.softmax(filtered, dim=-1), 1, generator=gen)
    return order.gather(-1, pick)[:, 0]


def make_generate(model, *, eos_id: int, pad_id: int, reply_type_id: int, max_new: int,
                  temperature: float = 0.0, top_p: float = 0.9):
    """generate(params, ids, types, prompt_len, gen=None) -> (ids', lengths)
    for a ``GPT2LMHead``, with ``params`` its parameter dict.

    - ids/types: [B, T] packed buffers; positions >= prompt_len[b] must be
      <pad> (they are overwritten as generation proceeds);
    - prompt_len: [B] int, the conditioning tokens per row (the reply's
      speaker token included);
    - ids' holds up to ``max_new`` generated tokens from prompt_len[b];
      lengths[b] = prompt_len[b] + the tokens generated before <eos> (the
      <eos> itself not counted);
    - gen: the CPU generator nucleus sampling draws from (unused when
      greedy).
    """
    from torch.func import functional_call

    def generate(params: dict, ids: torch.Tensor, types: torch.Tensor,
                 prompt_len: torch.Tensor, gen: torch.Generator | None = None):
        B, T = ids.shape
        rows = torch.arange(B, device=ids.device)
        cols = torch.arange(T, device=ids.device)
        cur = prompt_len.to(device=ids.device, dtype=torch.long)
        plen = cur.clone()
        done = torch.zeros(B, dtype=torch.bool, device=ids.device)
        with torch.no_grad():
            for _ in range(max_new):
                # logits at position cur - 1 predict the token at cur
                logits = functional_call(
                    model, params, (ids,),
                    {"train": False, "token_type_ids": types,
                     "logit_positions": (cur - 1).clamp_min(0)})
                nxt = _nucleus_pick(logits, gen, temperature, top_p).to(ids.device, ids.dtype)
                in_range = cur < T
                write = ~done & in_range
                nxt = torch.where(write, nxt, torch.full_like(nxt, pad_id))
                # write row b's token at cur[b] (elementwise: no scatter)
                at = (cols[None] == cur[:, None]) & write[:, None]
                ids = torch.where(at, nxt[:, None], ids)
                types = torch.where(at, torch.full_like(types, reply_type_id), types)
                done = done | (nxt == eos_id) | ~in_range
                cur = cur + write.long()
        # lengths exclude a trailing <eos> if one was written
        wrote_eos = (ids[rows, (cur - 1).clamp_min(0)] == eos_id) & (cur > plen)
        return ids, cur - wrote_eos.long()

    return generate


def decode_reply(tok, ids_row, prompt_len: int, length: int) -> str:
    """Detokenize the generated span of one row (host-side)."""
    return tok.decode([int(t) for t in ids_row[prompt_len:length]])


@functools.lru_cache(maxsize=None)
def _norm_word(w: str) -> str:
    return "".join(ch for ch in w.lower() if ch.isalnum())


def word_f1(pred: str, gold: str) -> float:
    """ConvAI2-style word-level F1: bag-of-words overlap of the normalized
    (lowercased, punctuation-stripped) prediction and gold reply."""
    p = [w for w in (_norm_word(t) for t in pred.split()) if w]
    g = [w for w in (_norm_word(t) for t in gold.split()) if w]
    if not p or not g:
        return float(p == g)
    overlap = sum((Counter(p) & Counter(g)).values())
    if overlap == 0:
        return 0.0
    precision, recall = overlap / len(p), overlap / len(g)
    return 2 * precision * recall / (precision + recall)
