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

With ``moe_experts`` E > 0 every ``moe_every``-th block (i % moe_every ==
moe_every - 1) replaces its MLP by ``moe_mlp``, a Switch top-1 mixture of
experts (``ops/moe.py``) with the reference's raw float32 parameters:
``router`` [n_embd, E], ``wi`` [E, n_embd, 4 n_embd] and ``wo``
[E, 4 n_embd, n_embd]. Routing and dispatch run in float32, the expert
products in the compute dtype. A forward given a list as ``moe_aux``
appends each MoE layer's load-balancing aux to it, in block order.

``remat`` recomputes each block's forward in the backward (``_Remat``,
the reference's ``nn.remat(Block)``): the block's activations are not
kept, its dropout masks are taken (or drawn) before the call and passed
in, and the result is bitwise the plain forward's and backward's.

Given ``axes`` (``parallel.collectives.ParallelAxes``), the model
computes over a group of ranks. On the ``model`` axis (tensor
parallelism, ``parallel/tp.py``) each rank takes H / M heads of
attention, 4C / M hidden units of the MLP and E / M experts of a mixture
of experts: copy-to-group before the column-parallel products, an
ordered sum after the row-parallel ones, the bias added once after it;
the attention-probability dropout mask is drawn whole and sliced by head.
On the ``seq`` axis (``attn_impl="ring"``) each rank carries its block of
T / S tokens through the whole model: ``wpe`` offset by the block, the
dropout masks drawn whole and sliced by token, attention by ring
attention (``ops/ring_attention.py``, which has no attention-probability
dropout, as the reference's ring branch has none), and a mixture of
experts gathering the group's tokens first, so that routing, capacity and
the aux see all B * T tokens in the reference's order. The logits are the
block's [B, T / S, V]; the mc head's score comes from the rank that holds
the position and is summed over the group. Without a seq axis,
``attn_impl="ring"`` is the one-rank form, ``_dense_causal``. The decode
fast path (``logit_positions``) on a seq group is the reference's decode
form, which runs outside its mesh: every rank computes whole rows through
``decode_view``, the model with the seq axis off (ring attention as
``_dense_causal``) and the model axis on.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import moe
from ..ops.ring_attention import ring_attention
from ..parallel import collectives, tp


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


def is_moe_block(cfg: GPT2Config, i: int) -> bool:
    """Whether block i's FFN is the mixture of experts (every
    ``moe_every``-th block, as the reference places it)."""
    return cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def check_config(cfg: GPT2Config) -> None:
    """Raise for a configuration the model does not have."""
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {cfg.dtype!r}")
    if cfg.attn_impl not in ("dense", "ring"):
        raise ValueError(f"attn_impl must be 'dense' or 'ring', got {cfg.attn_impl!r}")


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


def dropout(x: torch.Tensor, rate: float, gen, full: tuple | None = None,
            cut=None) -> torch.Tensor:
    """Inverted dropout, as flax's ``nn.Dropout``: kept values are scaled by
    1 / (1 - rate), dropped ones are exact zeros. The keep mask is drawn
    from ``gen`` (a ``torch.Generator``) or, for ``DropoutMasks``, is its
    next mask. No generator (eval) or rate 0: identity. A rank that holds
    a slice of the site's tensor draws the ``full`` shape and applies
    ``cut`` (its slice) to the mask."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(gen, DropoutMasks):
        mask = gen.take()
    else:
        mask = torch.rand(full or x.shape, generator=gen, device=x.device,
                          dtype=torch.float32) < keep
    if cut is not None:
        mask = cut(mask)
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
    return dense_wb(layer.weight, layer.bias, x, dtype)


def dense_wb(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``dense`` of a weight [out, in] and a bias [out] (None: no bias)."""
    w = weight.to(dtype)
    if bias is None:
        return F.linear(x.to(dtype), w)
    b = bias.to(dtype)
    if dtype == torch.float32:
        return F.linear(x, w, b)
    return F.linear(x.to(dtype), w) + b


def row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, axis) -> torch.Tensor:
    """A row-parallel ``dense``: this rank's input units' product, the
    ordered sum over the model group, then the bias, once."""
    y = collectives.reduce_from_group(dense_wb(tp.rows(layer.weight, axis), None, x, dtype), axis)
    return y + layer.bias.to(dtype)


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
    def __init__(self, cfg: GPT2Config, axes=None):
        super().__init__()
        self.cfg = cfg
        self.axes = axes
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, gen, seq_cut=None) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        B, T, C = x.shape
        mp = self.axes.model if self.axes is not None else None
        sq = self.axes.seq if self.axes is not None else None
        H, hd = cfg.n_head, cfg.head_dim
        if mp is not None:
            H //= mp.size
            qkv = dense_wb(tp.columns(self.c_attn.weight, mp, 3),
                           tp.columns(self.c_attn.bias, mp, 3),
                           collectives.copy_to_group(x, mp), dt)
        else:
            qkv = dense(self.c_attn, x, dt)
        q, k, v = (t.reshape(B, T, H, hd) for t in qkv.split(H * hd, dim=-1))
        if cfg.attn_impl == "ring":
            # no attention-probability dropout, as the reference's ring branch
            y = ring_attention(q, k, v, sq).reshape(B, T, H * hd)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            # 1 / sqrt(head_dim) rounded in the compute dtype, as the
            # reference computes it; a Python float of that value scales
            # without a copy
            scale = (1.0 / torch.sqrt(torch.tensor(float(hd), dtype=dt))).item()
            att = torch.matmul(q, k.transpose(-1, -2)) * scale
            causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
            att = att.masked_fill(~causal, torch.finfo(att.dtype).min)
            heads = None
            if mp is not None:  # the mask of every head, sliced to this rank's
                heads = lambda m: m.narrow(-3, mp.index * H, H)  # noqa: E731
            att = dropout(torch.softmax(att.float(), dim=-1).to(dt), cfg.dropout, gen,
                          full=(B, cfg.n_head, T, T), cut=heads)
            y = torch.matmul(att, v).transpose(1, 2).reshape(B, T, H * hd)
        y = row_parallel(self.c_proj, y, dt, mp) if mp is not None else dense(self.c_proj, y, dt)
        return dropout(y, cfg.dropout, gen, *(seq_cut or ()))


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, axes=None):
        super().__init__()
        self.cfg = cfg
        self.axes = axes
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, gen, seq_cut=None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        mp = self.axes.model if self.axes is not None else None
        if mp is None:
            y = dense(self.c_proj, gelu(dense(self.c_fc, x, dt)), dt)
        else:
            h = dense_wb(tp.columns(self.c_fc.weight, mp), tp.columns(self.c_fc.bias, mp),
                         collectives.copy_to_group(x, mp), dt)
            y = row_parallel(self.c_proj, gelu(h), dt, mp)
        return dropout(y, self.cfg.dropout, gen, *(seq_cut or ()))


class MoEMLP(nn.Module):
    """Switch top-1 mixture of experts in place of the FFN, the
    reference's ``MoEMLP``: raw float32 ``router`` [C, E], ``wi`` [E, C, 4C]
    and ``wo`` [E, 4C, C] (not ``nn.Linear``: the reference's layout, never
    permuted in the flat vector). Each expert computes gelu(h @ wi) @ wo in
    the compute dtype; ``moe.moe_ffn`` routes in float32. Returns the
    output in the compute dtype, after dropout, and the layer's aux."""

    def __init__(self, cfg: GPT2Config, axes=None):
        super().__init__()
        self.cfg = cfg
        self.axes = axes
        C, E = cfg.n_embd, cfg.moe_experts
        self.router = nn.Parameter(torch.empty(C, E))
        self.wi = nn.Parameter(torch.empty(E, C, 4 * C))
        self.wo = nn.Parameter(torch.empty(E, 4 * C, C))

    def forward(self, x: torch.Tensor, gen, seq_cut=None) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        dt = cfg.compute_dtype
        mp = self.axes.model if self.axes is not None else None
        sq = self.axes.seq if self.axes is not None and cfg.attn_impl == "ring" else None
        if sq is not None:
            # routing and capacity see the group's tokens in arrival order
            x = collectives.all_gather(x, sq, 1)
        B, T, C = x.shape

        def expert_fn(p: dict, h: torch.Tensor) -> torch.Tensor:
            h = torch.matmul(h.to(dt), p["wi"].to(dt))
            return torch.matmul(gelu(h), p["wo"].to(dt)).float()

        y, aux = moe.moe_ffn(x.reshape(B * T, C), self.router, {"wi": self.wi, "wo": self.wo},
                             expert_fn, capacity_factor=cfg.moe_capacity, axis=mp)
        y = y.reshape(B, T, C)
        if sq is not None:
            y = y.narrow(1, sq.index * (T // sq.size), T // sq.size)
        return dropout(y.to(dt), cfg.dropout, gen, *(seq_cut or ())), aux


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, use_moe: bool = False, axes=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        self.attn = Attention(cfg, axes)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        if use_moe:
            self.moe_mlp = MoEMLP(cfg, axes)
        else:
            self.mlp = MLP(cfg, axes)

    def forward(self, x: torch.Tensor, gen, moe_aux: list | None = None,
                seq_cut=None) -> torch.Tensor:
        # the norms return float32 (flax promotes); the sublayers return the
        # compute dtype, which the residual stream keeps
        x = x + self.attn(layer_norm(self.ln_1, x), gen, seq_cut)
        h = layer_norm(self.ln_2, x)
        if not hasattr(self, "moe_mlp"):
            return x + self.mlp(h, gen, seq_cut)
        y, aux = self.moe_mlp(h, gen, seq_cut)
        if moe_aux is not None:
            moe_aux.append(aux)
        return x + y


class _Remat(torch.autograd.Function):
    """``fn(*args)`` whose backward recomputes it: the forward keeps only
    its inputs, and the backward runs ``fn`` again under ``torch.func.vjp``
    for the cotangents of the first ``n_diff`` inputs (the rest, dropout
    masks, are constants). The same operations on the same inputs, so the
    values and gradients are bitwise the plain call's. Built from
    operations that ``torch.func`` transforms, so vmap's rule is generated
    and it runs under the engine's ``vmap(grad(...))``. The backward is not
    itself differentiable."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, n_diff, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, n_diff, *args = inputs
        ctx.fn, ctx.n_diff = fn, n_diff
        ctx.save_for_backward(*args)

    @staticmethod
    def backward(ctx, *gs):
        # detached: ``torch.func.grad`` differentiates with create_graph,
        # which would record the recompute and keep its activations alive
        # to the end of the backward (first-order gradients only)
        args = [a.detach() for a in ctx.saved_tensors]
        diff, rest = args[:ctx.n_diff], args[ctx.n_diff:]
        _, vjp_fn = torch.func.vjp(lambda *d: ctx.fn(*d, *rest), *diff)
        grads = vjp_fn(tuple(g.detach() for g in gs))
        return (None, None, *grads, *([None] * len(rest)))


def _remat_block(block: Block, x: torch.Tensor, gen, moe_aux, seq_cut, n_masks: int):
    """``block(x, ...)`` under ``_Remat``: the block's parameters and x are
    the differentiated inputs; its ``n_masks`` dropout masks are taken (or
    drawn, bitwise as the plain forward would draw them) before the call
    and passed in, so the recompute reads the same ones. ``gen`` is a
    ``DropoutMasks`` or None."""
    masks = [gen.take() for _ in range(n_masks)] if gen is not None else []
    names = [n for n, _ in block.named_parameters()]
    params = [p for _, p in block.named_parameters()]
    has_moe = hasattr(block, "moe_mlp")

    def fn(h, *rest):
        p = dict(zip(names, rest[:len(names)]))
        m = DropoutMasks(list(rest[len(names):])) if gen is not None else None
        auxs = [] if has_moe else None
        out = torch.func.functional_call(block, p, (h, m, auxs, seq_cut))
        return (out, auxs[0]) if has_moe else (out,)

    out = _Remat.apply(fn, 1 + len(params), x, *params, *masks)
    if has_moe and moe_aux is not None:
        moe_aux.append(out[1])
    return out[0]


class GPT2LMHead(nn.Module):
    """Causal LM with tied input/output embeddings; optional
    next-utterance-classification head (``cfg.with_mc_head``). ``axes``
    (``parallel.collectives.ParallelAxes``) are the seq and model groups
    it computes over (module docstring); None: one rank."""

    def __init__(self, cfg: GPT2Config, axes=None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        if axes is not None and axes.model is not None:
            tp.check_divides(cfg, axes.model.size)
        if axes is not None and axes.seq is not None and cfg.attn_impl != "ring":
            # the reference's seq axis splits only ring attention's blocks:
            # with dense attention its ranks compute the whole sequence
            axes = dataclasses.replace(axes, seq=None)
        self.axes = axes if axes is not None and (axes.seq or axes.model) else None
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd))
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, use_moe=is_moe_block(cfg, i), axes=self.axes))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.ln_eps)
        if cfg.with_mc_head:
            self.mc_head = nn.Parameter(torch.empty(cfg.n_embd))

    @property
    def seq_axis(self):
        """The seq group's axis (None: the model sees whole sequences)."""
        return self.axes.seq if self.axes is not None else None

    def decode_view(self) -> "GPT2LMHead":
        """This model with the seq axis off and the model axis kept: the
        same parameter names, built once on the meta device (it holds no
        weights of its own; a forward gives it this model's through
        ``functional_call``) and kept outside the module tree."""
        view = self.__dict__.get("_decode_view")
        if view is None:
            with torch.device("meta"):
                view = GPT2LMHead(self.cfg, dataclasses.replace(self.axes, seq=None))
            self.__dict__["_decode_view"] = view
        return view

    def forward(self, input_ids: torch.Tensor, train: bool = True,
                token_type_ids: torch.Tensor | None = None,
                logit_positions: torch.Tensor | None = None,
                gen=None,
                mc_positions: torch.Tensor | None = None,
                moe_aux: list | None = None):
        """Logits [B, T, V] (float32), or [B, V] at one position per row
        with ``logit_positions`` [B] (the decode fast path), or with the mc
        head and ``mc_positions`` [B] the pair (logits [B, T, V], scores
        [B]). Dropout runs when ``train`` and draws from ``gen``, which it
        then needs: a generator, or the list of masks ``dropout_masks``
        drew from one. Given a list, ``moe_aux`` receives each MoE layer's
        load-balancing aux in block order. On a seq group ``input_ids`` is
        the whole [B, T] row and the logits are this rank's block
        [B, T / S, V], but with ``logit_positions`` every rank computes the
        whole rows (``decode_view``) and returns the [B, V] logits."""
        cfg = self.cfg
        if train and cfg.dropout > 0 and gen is None:
            raise ValueError("a training forward with dropout needs a generator or its masks")
        gen = gen if train and cfg.dropout > 0 else None
        if isinstance(gen, torch.Generator) and cfg.remat:
            # a rematerialised block must read the same masks twice
            gen = self.dropout_masks(tuple(input_ids.shape), gen)
        if isinstance(gen, (list, tuple)):
            gen = DropoutMasks(gen)
        B, T = input_ids.shape
        C = cfg.n_embd
        sq = self.seq_axis
        lo, seq_cut = 0, None
        if sq is not None and logit_positions is not None:
            # the reference decodes outside its mesh: whole rows, ring
            # attention's one-rank form, on every rank alike
            return torch.func.functional_call(
                self.decode_view(), dict(self.named_parameters()), (input_ids,),
                {"train": train, "token_type_ids": token_type_ids,
                 "logit_positions": logit_positions, "gen": gen, "moe_aux": moe_aux})
        if sq is not None:
            if T % sq.size:
                raise ValueError(f"seq_len {T} is not divisible by the {sq.size}-way seq group")
            Tl = T // sq.size
            lo = sq.index * Tl
            input_ids = input_ids.narrow(1, lo, Tl)
            if token_type_ids is not None:
                token_type_ids = token_type_ids.narrow(1, lo, Tl)
            seq_cut = ((B, T, C), lambda m: m.narrow(-2, lo, Tl))
        Tl = input_ids.shape[1]
        x = F.embedding(input_ids.long(), self.wte) + self.wpe.narrow(0, lo, Tl)[None]
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids.long(), self.wte)
        x = dropout(x.to(cfg.compute_dtype), cfg.dropout, gen, *(seq_cut or ()))
        n_masks = 2 if cfg.attn_impl == "ring" else 3
        for i in range(cfg.n_layer):
            block = getattr(self, f"h_{i}")
            if cfg.remat:
                x = _remat_block(block, x, gen, moe_aux, seq_cut, n_masks)
            else:
                x = block(x, gen, moe_aux, seq_cut)
        if isinstance(gen, DropoutMasks) and gen.left:
            raise ValueError(f"{gen.left} dropout masks left over after the forward")
        x = layer_norm(self.ln_f, x)
        if logit_positions is not None:
            return torch.matmul(gather_at(x, logit_positions), self.wte.t())
        lm_logits = torch.matmul(x, self.wte.t())
        if not cfg.with_mc_head or mc_positions is None:
            return lm_logits
        if sq is None:
            return lm_logits, gather_at(x, mc_positions) @ self.mc_head
        # the rank that holds a position scores it; the others add zero
        local = mc_positions.long() - lo
        mine = (local >= 0) & (local < Tl)
        score = gather_at(x, local.clamp(0, Tl - 1)) @ self.mc_head
        return lm_logits, collectives.sum_partial(torch.where(mine, score, 0.0), sq)

    def dropout_masks(self, batch_shape: tuple, gen: torch.Generator) -> list[torch.Tensor]:
        """The keep masks a training forward over ``input_ids`` of shape
        ``batch_shape`` (B, T) draws from ``gen``, drawn here instead, with
        one ``torch.rand`` per dropout site in the forward's order and at
        its shape (the embedding [B, T, C], then per block the attention
        probabilities [B, H, T, T] (not under ring attention, which has no
        such dropout), the attention output and the MLP's or the MoE's
        output [B, T, C]): bitwise the masks the forward would draw, whole
        on every rank of a group (each rank slices its own). Passed as
        ``gen`` (a list), the forward reads them in that order. [] with
        dropout off."""
        cfg = self.cfg
        if cfg.dropout == 0.0:
            return []
        B, T = batch_shape
        probs = [] if cfg.attn_impl == "ring" else [(B, cfg.n_head, T, T)]
        shapes = [(B, T, cfg.n_embd)] + (probs + [(B, T, cfg.n_embd)] * 2) * cfg.n_layer
        keep = 1.0 - cfg.dropout
        return [torch.rand(s, generator=gen, device=gen.device, dtype=torch.float32) < keep
                for s in shapes]


def init_weights(model: GPT2LMHead, seed: int) -> None:
    """Initialise in place like the reference's flax init, from an explicit
    generator: ``wte`` normal(0.02), ``wpe`` normal(0.01), Dense kernels
    lecun-normal (normal truncated at two standard deviations, variance
    1 / fan_in), biases 0, LayerNorm scales 1, ``mc_head`` normal(0.02)
    (drawn last, so the head changes no other draw), the MoE ``router`` and
    ``wi`` normal(0.02) and ``wo`` normal(0.02 / sqrt(2 n_layer)). The
    distributions match the reference's, not the draws."""
    gen = torch.Generator().manual_seed(seed)
    wo_std = 0.02 / (2 * model.cfg.n_layer) ** 0.5
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("wte", "mc_head"):
                p.normal_(0.0, 0.02, generator=gen)
            elif ".moe_mlp." in name:
                p.normal_(0.0, wo_std if name.endswith(".wo") else 0.02, generator=gen)
            elif name == "wpe":
                p.normal_(0.0, 0.01, generator=gen)
            elif p.dim() == 2:  # linear [out, in]
                std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.zero_()
