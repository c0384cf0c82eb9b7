"""GPT-2 (LM head, tied embeddings, optional next-utterance-classification
head): the port's twin of the JAX package's ``models/gpt2.py``, dense
attention in float32 or bfloat16.

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
randomness is a function of the round alone. Under ``torch.func.vmap``
nothing may draw: ``dropout_masks`` draws a forward's masks beforehand,
bitwise the same, and the forward takes them in the generator's place.
The masks differ from the reference's (threefry is not ported): parity
with dropout on is distributional.

``dtype="bfloat16"`` computes as the reference does, cast for cast:
parameters stay float32; the embeddings are summed in float32 and the
residual stream is then bfloat16; every LayerNorm normalises in float32 and
returns float32 (flax promotes to its float32 parameters); each dense layer
casts its input, kernel and bias to bfloat16 and returns bfloat16; the
attention scale 1/sqrt(head_dim) is rounded in bfloat16, the mask fill is
bfloat16's lowest value, and the softmax runs in float32 and is cast back
before dropout and the second product. The LM logits, and the mc head's
scores, are float32 products of the float32 final LayerNorm.

With ``with_mc_head`` the model owns a raw ``mc_head`` [n_embd] parameter;
given ``mc_positions`` [B] the forward returns ``(lm_logits, scores)``,
scores[b] the float32 hidden state at mc_positions[b] dotted with it.

Not ported (a config asking for them raises): ring attention, mixture of
experts and rematerialisation.
"""

from __future__ import annotations

import dataclasses
import math

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
    ) if on]
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {cfg.dtype!r}")
    if unported:
        raise NotImplementedError(f"GPT-2 {', '.join(unported)}: not ported")


class DropoutMasks:
    """The keep masks of one training forward, in the order its dropout
    sites read them (``GPT2LMHead.dropout_masks``): the engine draws them
    outside ``torch.func.vmap`` and passes them in as batched inputs."""

    def __init__(self, masks):
        self._masks = iter(masks)
        self.left = len(masks)

    def take(self) -> torch.Tensor:
        self.left -= 1
        return next(self._masks)


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Inverted dropout, as flax's ``nn.Dropout``: kept values are scaled by
    1 / (1 - rate), dropped ones are exact zeros. The keep mask is drawn
    from ``gen`` (a ``torch.Generator``) or, for ``DropoutMasks``, is its
    next mask. No generator (eval) or rate 0: identity."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(gen, DropoutMasks):
        mask = gen.take()
    else:
        mask = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def gather_at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[B, C] rows of x[B, T, C] at per-row positions pos[B], as
    ``take_along_axis`` (``torch.gather``, whose backward is deterministic
    on CUDA)."""
    idx = pos.long().reshape(-1, 1, 1).expand(-1, 1, x.shape[-1])
    return x.gather(1, idx)[:, 0]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``, the product returned in ``dtype``. In bfloat16 the product
    is rounded before the bias is added, as flax adds it (a bias fused into
    the GEMM rounds once, and then differs in about 3 elements of 10)."""
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if dtype == torch.float32:
        return F.linear(x, w, b)
    return F.linear(x.to(dtype), w) + b


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.LayerNorm`` (float32 parameters) of ``x``, in float32.
    For a bfloat16 ``x`` as flax computes it: the statistics from one cast
    of x (mean and E[x^2] - mean^2, clamped at 0), the normalisation from
    another, so that the backward rounds each cast's cotangent to bfloat16
    on its own before adding them, as JAX's does."""
    if x.dtype == torch.float32:
        return ln(x)
    xs = x.float()
    mu = xs.mean(-1, keepdim=True)
    var = ((xs * xs).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x.float() - mu) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias


class _GeluBF16(torch.autograd.Function):
    """``jax.nn.gelu(approximate=True)`` of a bfloat16 tensor, forward and
    backward, with the primitives JAX's autodiff emits, each result rounded
    to bfloat16 and the constants rounded first (sqrt(2/pi) -> 0.796875,
    0.044715 -> 0.044677734375). The forward also returns the tanh and the
    half factor it computed, which the backward reuses; elementwise, so
    ``torch.func.vmap`` generates its batching rule."""

    generate_vmap_rule = True

    @staticmethod
    def _constants(dtype: torch.dtype) -> tuple[float, float]:
        # made on the CPU from Python floats: no device round trip
        return tuple(torch.tensor(c, dtype=dtype).item()
                     for c in (math.sqrt(2.0 / math.pi), 0.044715))

    @staticmethod
    def forward(x: torch.Tensor):
        k0, k1 = _GeluBF16._constants(x.dtype)
        t = torch.tanh(k0 * (x + k1 * x ** 3))
        half = 0.5 * (1.0 + t)
        return x * half, t, half

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,), (_, t, half) = inputs, output
        ctx.save_for_backward(x, t, half)
        ctx.mark_non_differentiable(t, half)
        ctx.k = _GeluBF16._constants(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor, _gt, _ghalf) -> torch.Tensor:
        x, t, half = ctx.saved_tensors
        k0, k1 = ctx.k
        p = (0.5 * (x * g)) * (1.0 - t)  # through x * half, then tanh
        s = k0 * (p + p * t)
        return (g * half + s) + (k1 * s) * (3.0 * x ** 2)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximated GELU as ``jax.nn.gelu(approximate=True)``
    computes it: ``F.gelu`` in float32; in bfloat16 op by op, each result
    rounded, forward and backward (``_GeluBF16``). ``F.gelu`` would round
    once and then differ in about 4 elements of 10, and its backward in
    about 2 of 10."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    return _GeluBF16.apply(x)[0]


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, gen) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        B, T, C = x.shape
        q, k, v = dense(self.c_attn, x, dt).split(C, dim=-1)
        q, k, v = (t.reshape(B, T, cfg.n_head, cfg.head_dim).transpose(1, 2) for t in (q, k, v))
        # 1 / sqrt(head_dim) rounded in the compute dtype, as the reference
        # computes it; a Python float of that value scales without a copy
        scale = (1.0 / torch.sqrt(torch.tensor(float(cfg.head_dim), dtype=dt))).item()
        att = torch.matmul(q, k.transpose(-1, -2)) * scale
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~causal, torch.finfo(att.dtype).min)
        att = dropout(torch.softmax(att.float(), dim=-1).to(dt), cfg.dropout, gen)
        y = torch.matmul(att, v).transpose(1, 2).reshape(B, T, C)
        return dropout(dense(self.c_proj, y, dt), cfg.dropout, gen)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, gen) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        h = gelu(dense(self.c_fc, x, dt))
        return dropout(dense(self.c_proj, h, dt), self.cfg.dropout, gen)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, gen) -> torch.Tensor:
        # the norms return float32 (flax promotes); the sublayers return the
        # compute dtype, which the residual stream keeps
        x = x + self.attn(layer_norm(self.ln_1, x), gen)
        return x + self.mlp(layer_norm(self.ln_2, x), gen)


class GPT2LMHead(nn.Module):
    """Causal LM with tied input/output embeddings; optional
    next-utterance-classification head (``cfg.with_mc_head``)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd))
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        if cfg.with_mc_head:
            self.mc_head = nn.Parameter(torch.empty(cfg.n_embd))

    def forward(self, input_ids: torch.Tensor, train: bool = True,
                token_type_ids: torch.Tensor | None = None,
                logit_positions: torch.Tensor | None = None,
                gen=None,
                mc_positions: torch.Tensor | None = None):
        """Logits [B, T, V] (float32), or [B, V] at one position per row
        with ``logit_positions`` [B] (the decode fast path), or with the mc
        head and ``mc_positions`` [B] the pair (logits [B, T, V], scores
        [B]). Dropout runs when ``train`` and draws from ``gen``, which it
        then needs: a generator, or the list of masks ``dropout_masks``
        drew from one."""
        cfg = self.cfg
        if train and cfg.dropout > 0 and gen is None:
            raise ValueError("a training forward with dropout needs a generator or its masks")
        gen = gen if train else None
        if isinstance(gen, (list, tuple)):
            gen = DropoutMasks(gen)
        T = input_ids.shape[1]
        x = F.embedding(input_ids.long(), self.wte) + self.wpe[:T][None]
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids.long(), self.wte)
        x = dropout(x.to(cfg.compute_dtype), cfg.dropout, gen)
        for i in range(cfg.n_layer):
            x = getattr(self, f"h_{i}")(x, gen)
        if isinstance(gen, DropoutMasks) and gen.left:
            raise ValueError(f"{gen.left} dropout masks left over after the forward")
        x = layer_norm(self.ln_f, x)
        if logit_positions is not None:
            return torch.matmul(gather_at(x, logit_positions), self.wte.t())
        lm_logits = torch.matmul(x, self.wte.t())
        if not cfg.with_mc_head or mc_positions is None:
            return lm_logits
        return lm_logits, gather_at(x, mc_positions) @ self.mc_head

    def dropout_masks(self, batch_shape: tuple, gen: torch.Generator) -> list[torch.Tensor]:
        """The keep masks a training forward over ``input_ids`` of shape
        ``batch_shape`` (B, T) draws from ``gen``, drawn here instead, with
        one ``torch.rand`` per dropout site in the forward's order and at
        its shape (the embedding [B, T, C], then per block the attention
        probabilities [B, H, T, T], the attention output and the MLP output
        [B, T, C]): bitwise the masks the forward would draw. Passed as
        ``gen`` (a list), the forward reads them in that order. [] with
        dropout off."""
        cfg = self.cfg
        if cfg.dropout == 0.0:
            return []
        B, T = batch_shape
        shapes = [(B, T, cfg.n_embd)] + [(B, cfg.n_head, T, T), (B, T, cfg.n_embd),
                                         (B, T, cfg.n_embd)] * cfg.n_layer
        keep = 1.0 - cfg.dropout
        return [torch.rand(s, generator=gen, device=gen.device, dtype=torch.float32) < keep
                for s in shapes]


def init_weights(model: GPT2LMHead, seed: int) -> None:
    """Initialise in place like the reference's flax init, from an explicit
    generator: ``wte`` normal(0.02), ``wpe`` normal(0.01), Dense kernels
    lecun-normal (normal truncated at two standard deviations, variance
    1 / fan_in), biases 0, LayerNorm scales 1, ``mc_head`` normal(0.02)
    (drawn last, so the head changes no other draw). The distributions
    match the reference's, not the draws."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("wte", "mc_head"):
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
