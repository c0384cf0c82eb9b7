"""Ring attention: causal attention with the sequence split over a seq
group of ranks, the K/V blocks passing round the ring: the port's twin of
the JAX package's ``ops/ring_attention.py``.

Each rank holds its query block and a running (max, sum, acc) triple in
float32. At each of the S ring steps it attends its queries to the K/V
block it holds (the block of rank ``(me - s) mod S``), masked causally by
global token positions, then passes that block to the next rank
(``collectives.shift``, whose backward sends the cotangent back: the
transpose of ``jax.lax.ppermute``). The numerics are the reference's ring
branch, not its dense one: q scaled by 1/sqrt(D) in float32, scores
masked with -1e30, the online softmax in float32, ``acc / max(l, 1e-30)``,
the result cast back to q's dtype. Every step runs on every rank, so the
ranks' graphs have one shape (no block is skipped).

Layout: q, k, v are this rank's blocks [B, T/S, H, D]; so is the output.
Without a group the function is ``_dense_causal``, the one-rank form.
Each block product is a ``torch.matmul``, as the reference's are XLA
einsums.
"""

from __future__ import annotations

import torch

from ..parallel import collectives

_NEG = -1e30


def _dense_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention over whole [B, T, H, D] blocks: the scale
    1/sqrt(D) in q's dtype, the mask -1e30, the softmax in float32 cast
    back to q's dtype."""
    D, T = q.shape[-1], q.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=q.dtype, device=q.device))
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    att = torch.where(mask[None, None], att, torch.tensor(_NEG, dtype=att.dtype,
                                                           device=att.device))
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att, v)


def _ring_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                axis: collectives.Axis) -> torch.Tensor:
    """The ring over ``axis`` on local blocks [B, Tl, H, D]."""
    B, Tl, H, D = q.shape
    S, me = axis.size, axis.index
    scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32, device=q.device))
    qf = q.float() * scale
    pos = torch.arange(Tl, device=q.device)
    q_pos = me * Tl + pos
    m = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for s in range(S):
        src = (me - s) % S  # whose K/V block this rank holds at step s
        k_pos = src * Tl + pos
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]  # causal, global ids
        scores = torch.where(mask, scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None]) * mask
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
        if s < S - 1:
            # the last step's blocks would go unread: no rank sends them
            k_blk = collectives.shift(k_blk, axis)
            v_blk = collectives.shift(v_blk, axis)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, H, Tl, D]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: collectives.Axis | None = None, causal: bool = True) -> torch.Tensor:
    """Causal attention of this rank's blocks [B, T/S, H, D] over the seq
    group ``axis``; without one (or a group of one), ``_dense_causal`` of
    the whole [B, T, H, D]."""
    if not causal:
        raise NotImplementedError("ring_attention is causal-only (LM path)")
    if axis is None or axis.size == 1:
        return _dense_causal(q, k, v)
    return _ring_local(q, k, v, axis)
