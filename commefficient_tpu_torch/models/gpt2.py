"""GPT-2 (LM head, tied embeddings): the port's twin of the JAX package's
``models/gpt2.py``, dense attention in float32.

The modules carry flax's names (``h_{i}``, ``attn/c_attn``, ``attn/c_proj``,
``ln_1``, ``ln_2``, ``mlp/c_fc``, ``mlp/c_proj``, ``ln_f``, ``wte``, ``wpe``)
so that ``models/convert.py`` maps them onto ``ravel_pytree``'s flat order.
The arithmetic follows the reference, not a library shortcut: attention by
explicit matrix products with the causal mask filled with float32's lowest
value (not -inf) and the softmax in float32, tanh-approximated GELU,
LayerNorm with eps 1e-5, token-type embeddings looked up in ``wte`` and the
tied LM head ``x @ wte.T`` in float32.

Dropout draws its keep masks from an explicit ``torch.Generator`` (the
engine makes one per round, client slot and local step), so a round's
randomness is a function of the round alone. The masks differ from the
reference's (threefry is not ported): parity with dropout on is
distributional.

Not ported (a config asking for them raises): ring attention, mixture of
experts, rematerialisation, the next-utterance-classification head and
bfloat16 compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.1
    dtype: str = "float32"  # compute dtype for activations
    remat: bool = False
    attn_impl: str = "dense"  # "dense" | "ring"
    ring_axis: str = "seq"
    with_mc_head: bool = False  # next-utterance-classification head
    moe_experts: int = 0  # > 0: every moe_every-th block's MLP is a top-1 MoE
    moe_every: int = 2
    moe_capacity: float = 1.25
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


TINY = GPT2Config(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=2, dropout=0.0)
SMALL = GPT2Config()  # GPT-2 small: 124M params at the BPE vocabulary


def check_ported(cfg: GPT2Config) -> None:
    """Raise for a configuration the port does not run."""
    unported = [what for what, on in (
        ("attn_impl='ring' (ring attention)", cfg.attn_impl != "dense"),
        ("moe_experts > 0 (mixture of experts)", cfg.moe_experts > 0),
        ("remat (rematerialisation)", cfg.remat),
        ("with_mc_head (next-utterance-classification head)", cfg.with_mc_head),
        ("dtype='bfloat16'", cfg.dtype != "float32"),
    ) if on]
    if unported:
        raise NotImplementedError(f"GPT-2 {', '.join(unported)}: not ported")


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``gen``, as flax's
    ``nn.Dropout``: kept values are scaled by 1 / (1 - rate), dropped ones
    are exact zeros. No generator (eval) or rate 0: identity."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def gather_at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[B, ...rest] rows of x[B, T, ...rest] at per-row positions pos[B]."""
    return x[torch.arange(x.shape[0], device=x.device), pos.long()]


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
        cfg = self.cfg
        B, T, C = x.shape
        q, k, v = self.c_attn(x).split(C, dim=-1)
        q, k, v = (t.reshape(B, T, cfg.n_head, cfg.head_dim).transpose(1, 2) for t in (q, k, v))
        # 1 / sqrt(head_dim) rounded in float32 as the reference computes it
        scale = float(np.float32(1.0) / np.sqrt(np.float32(cfg.head_dim)))
        att = torch.matmul(q, k.transpose(-1, -2)) * scale
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~causal, torch.finfo(att.dtype).min)
        att = dropout(torch.softmax(att.float(), dim=-1), cfg.dropout, gen)
        y = torch.matmul(att, v).transpose(1, 2).reshape(B, T, C)
        return dropout(self.c_proj(y), cfg.dropout, gen)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
        h = F.gelu(self.c_fc(x), approximate="tanh")
        return dropout(self.c_proj(h), self.cfg.dropout, gen)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), gen)
        return x + self.mlp(self.ln_2(x), gen)


class GPT2LMHead(nn.Module):
    """Causal LM with tied input/output embeddings."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd))
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)

    def forward(self, input_ids: torch.Tensor, train: bool = True,
                token_type_ids: torch.Tensor | None = None,
                logit_positions: torch.Tensor | None = None,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """Logits [B, T, V] (float32), or [B, V] at one position per row
        with ``logit_positions`` [B] (the decode fast path). Dropout runs
        when ``train`` and draws from ``gen``, which it then needs."""
        cfg = self.cfg
        if train and cfg.dropout > 0 and gen is None:
            raise ValueError("a training forward with dropout needs a generator")
        gen = gen if train else None
        T = input_ids.shape[1]
        x = F.embedding(input_ids.long(), self.wte) + self.wpe[:T][None]
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids.long(), self.wte)
        x = dropout(x, cfg.dropout, gen)
        for i in range(cfg.n_layer):
            x = getattr(self, f"h_{i}")(x, gen)
        x = self.ln_f(x)
        if logit_positions is not None:
            x = gather_at(x, logit_positions)
        return torch.matmul(x.float(), self.wte.t())


def init_weights(model: GPT2LMHead, seed: int) -> None:
    """Initialise in place like the reference's flax init, from an explicit
    generator: ``wte`` normal(0.02), ``wpe`` normal(0.01), Dense kernels
    lecun-normal (normal truncated at two standard deviations, variance
    1 / fan_in), biases 0, LayerNorm scales 1. The distributions match the
    reference's, not the draws."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "wte":
                p.normal_(0.0, 0.02, generator=gen)
            elif name == "wpe":
                p.normal_(0.0, 0.01, generator=gen)
            elif p.dim() == 2:  # linear [out, in]
                std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.zero_()
