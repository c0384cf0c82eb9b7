"""Switch-Transformer top-1 mixture-of-experts FFN: the port's twin of the
JAX package's ``ops/moe.py``.

Semantics (top-1, capacity factor c):
- router logits [T, E] -> gate = softmax (float32); expert = argmax.
- each expert takes at most C = max(1, ceil(c * T / E)) tokens, by their
  position in its queue in arrival order; overflow tokens pass through.
- output = gate * expert_out + (1 - routed) * x (a dropped token keeps x).
- the Switch load-balancing aux E * sum_e f_e * p_e, returned so that a
  loss can add ``aux_coef * aux``.

``top1_dispatch`` builds the reference's dense one-hot dispatch and combine
tensors [T, E, C]. ``moe_ffn`` computes the same two products without
them: each (expert, slot) column of the dispatch and each token's row of
the combine holds one nonzero, so the products are gathers. The token of
slot (e, c) is the c-th kept token routed to e, found by a sort of unique
keys; a gather then fills the expert queues, and another reads each
token's expert output. The sums the dense products would add are a single
term and exact zeros, so the gathers give their values (up to the sign of
a zero, in slots no token fills) at O(T * D) instead of O(T * E * C * D)
work and [T, E, C] memory: at an evaluation batch of 512 rows of 256
tokens the dense dispatch alone would be 86 GB. Nothing has a
data-dependent shape, and every operation (integer cumsum, sort, gather
and its scatter-add backward) has a deterministic CUDA kernel, so the
block runs under ``torch.func.vmap`` over a cohort and under
``torch.use_deterministic_algorithms``.

Given the ``model`` axis of a group of M ranks, the experts split over it
(expert parallelism, the reference's ``P("model", None, None)`` on the
[E, ...] leaves): routing is replicated, each rank runs its E / M experts'
queues, and the experts' outputs are summed over the group (each rank's
rows of the others' experts are zeros). The expert inputs pass through
copy-to-group, so their gradient sums the ranks' shares.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..parallel import collectives


def _route(router_logits: torch.Tensor, capacity: int):
    """(probs [T, E] float32, expert [T], hot [T, E] bool, pos [T] queue
    position, kept [T] bool, aux) of top-1 routing."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    expert = probs.argmax(-1)  # the first of tied maxima, as jnp.argmax
    hot = expert[:, None] == torch.arange(E, device=expert.device)
    # the queue position in arrival order: an integer cumsum (exact, and
    # deterministic on CUDA, where a float cumsum has no such kernel)
    hot_i = hot.to(torch.int64)
    pos = ((torch.cumsum(hot_i, 0) - 1) * hot_i).sum(-1)
    kept = pos < capacity
    # Switch load-balancing aux: E * sum_e (fraction routed to e) * (mean prob e)
    aux = E * torch.sum(hot.float().mean(0) * probs.mean(0))
    return probs, expert, hot, pos, kept, aux


def top1_dispatch(router_logits: torch.Tensor, capacity: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dispatch [T, E, C] 0/1 float32, combine [T, E, C] float32, aux) of
    top-1 routing over ``router_logits`` [T, E], the reference's dense
    tensors: token t takes slot p of expert e when e is its argmax and p,
    its 0-based arrival position among the tokens routed to e, is below
    ``capacity``."""
    probs, _, hot, pos, kept, aux = _route(router_logits, capacity)
    kept_hot = hot & kept[:, None]  # [T, E]
    slot = pos[:, None] == torch.arange(capacity, device=pos.device)  # [T, C]
    dispatch = (kept_hot[:, :, None] & slot[:, None, :]).float()
    gate = (probs * kept_hot.float()).sum(-1)  # [T]
    return dispatch, dispatch * gate[:, None, None], aux


def capacity_of(tokens: int, experts: int, capacity_factor: float) -> int:
    """C = max(1, ceil(capacity_factor * tokens / experts))."""
    return max(1, math.ceil(capacity_factor * tokens / experts))


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, expert_params: dict,
            expert_fn: Callable, *, capacity_factor: float = 1.25, axis=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE FFN over tokens x [T, D]: (y [T, D] in x's dtype, aux).
    ``expert_params`` holds tensors with a leading expert axis [E, ...];
    ``expert_fn(params, h [E, C, D]) -> [E, C, D]`` applies every expert to
    its own queue (a batched product over E, the reference's vmap over
    experts). Routing, dispatch and combine run in float32, as the
    reference's dense products, by gathers (module docstring). ``axis``,
    the model group's, splits the experts over its ranks."""
    T, D = x.shape
    E = next(iter(expert_params.values())).shape[0]
    C = capacity_of(T, E, capacity_factor)
    xf = x.float()
    probs, expert, hot, pos, kept, aux = _route(xf @ router_w, C)
    # the kept tokens in (expert, arrival) order: expert e's queue is the
    # run of `count[e]` tokens from `start[e]`
    tok = torch.arange(T, device=x.device)
    order = torch.sort(torch.where(kept, expert * T + tok, E * T + tok)).indices
    count = (hot & kept[:, None]).sum(0)  # [E]
    start = torch.cumsum(count, 0) - count
    slots = torch.arange(C, device=x.device)
    filled = slots[None, :] < count[:, None]  # [E, C]
    src = order[(start[:, None] + slots[None, :]).clamp(max=T - 1)].reshape(-1, 1)
    xe = xf if axis is None else collectives.copy_to_group(xf, axis)
    h = torch.where(filled.reshape(-1, 1), xe.gather(0, src.expand(-1, D)), 0.0)
    if axis is None:
        y = expert_fn(expert_params, h.reshape(E, C, D)).float().reshape(E * C, D)
    else:
        k = E // axis.size
        lo = axis.index * k
        mine = {n: t.narrow(0, lo, k) for n, t in expert_params.items()}
        y = expert_fn(mine, h.reshape(E, C, D).narrow(0, lo, k)).float()
        y = torch.cat([y.new_zeros((lo, C, D)), y, y.new_zeros((E - lo - k, C, D))])
        y = collectives.reduce_from_group(y, axis).reshape(E * C, D)
    # each kept token's output, gate-weighted; routed = the gate mass that landed
    at = (expert * C + pos.clamp(max=C - 1))[:, None].expand(-1, D)
    gate = torch.where(kept, probs.gather(1, expert[:, None])[:, 0], 0.0)
    out = torch.where(kept[:, None], gate[:, None] * y.gather(0, at), 0.0)
    out = out + (1.0 - gate)[:, None] * xf
    return out.to(x.dtype), aux


def dense_oracle(x: torch.Tensor, router_w: torch.Tensor, expert_params: dict,
                 expert_fn: Callable) -> torch.Tensor:
    """Every token through its argmax expert with no capacity limit: what
    ``moe_ffn`` gives while the capacity does not bind (O(E * T * D))."""
    T, _ = x.shape
    xf = x.float()
    probs = torch.softmax(xf @ router_w, dim=-1)
    expert = probs.argmax(-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    E = next(iter(expert_params.values())).shape[0]
    all_y = expert_fn(expert_params, xf[None].expand(E, T, xf.shape[1]))  # [E, T, D]
    sel = all_y[expert, torch.arange(T, device=x.device)]  # [T, D]
    return (gate[:, None] * sel + (1.0 - gate)[:, None] * xf).to(x.dtype)
