"""Collectives over one axis of the mesh that autograd and ``torch.func``
see through: the port's counterpart of the collectives the JAX package
gets from GSPMD and ``shard_map`` (``psum``, ``all_gather``, ``ppermute``)
on its ``seq`` and ``model`` axes.

Each is a ``torch.autograd.Function`` with ``setup_context`` and a
``vmap`` staticmethod, so that it runs inside the engine's
``torch.func.vmap(torch.func.grad(...))`` over a cohort: under the map the
rule moves the client axis to the front and issues ONE collective on the
whole batched tensor, never one per client. The backward of each calls
another of these Functions, so that it too runs under the map. Every rank
of a group must call them in the same order, forward and backward; a
model whose ranks build graphs of one shape does.

Every sum over a group is ordered: the group's tensors are all-gathered
and added in rank order, so every rank holds the same bits and two runs
of one seed agree bitwise (an ``all_reduce`` may add in any order). Over
gloo a CUDA tensor is staged through host memory, which is how that
backend moves card memory. A failed collective raises; nothing falls back.

Two conventions meet here, and each Function says which it serves:

- a *replicated* consumer (tensor parallelism on the ``model`` axis):
  every rank of the group computes the same loss from the same
  activations, so the cotangent of a replicated tensor is the same on
  every rank. Megatron's pair: ``copy_to_group`` (forward identity,
  backward sum) before a column-parallel product and ``reduce_from_group``
  (forward sum, backward identity) after a row-parallel one.
- a *partial* loss (sequence parallelism on the ``seq`` axis): each rank's
  loss is its block's share of the total, and the total gradient is the
  sum of the ranks'. ``all_gather`` (backward: the reduce-scatter),
  ``sum_partial`` (forward and backward sums) and ``shift`` (the ring's
  send-to-next; backward: send-to-previous, the transpose of JAX's
  ``ppermute``).

``broadcast_from`` is the GPipe hand-off of the last stage's output to
every rank: its backward gives the source rank its own cotangent, once,
as the transpose of the reference's masked ``psum`` does (the ranks' loss
is replicated, so summing the S equal cotangents would scale the stage
gradients S times).
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

# bytes this process moved in the collectives here, and the host ms spent
# in them, since the counts were last set to 0 (chip_smoke reads them)
stats = {"calls": 0, "bytes": 0, "ms": 0.0}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: the process ``group`` of
    the ranks that differ from it only along the axis, its ``size`` and
    this rank's ``index`` along it (its rank in ``group``)."""

    group: object
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class ParallelAxes:
    """The ``seq`` and ``model`` axes a model computes over (None: the
    axis has size 1)."""

    seq: Axis | None = None
    model: Axis | None = None


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _timed(fn):
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        stats["calls"] += 1
        stats["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    return run


@_timed
def _gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on each), in rank order, on
    x's device: one ``all_gather``."""
    S = dist.get_world_size(group)
    dev = x.device
    buf = x.detach().contiguous()
    staged = _staged(buf, group)
    if staged:
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(S)]
    dist.all_gather(parts, buf, group=group)
    stats["bytes"] += buf.numel() * buf.element_size() * (S - 1)
    return [p.to(dev) for p in parts] if staged else parts


@_timed
def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """The ``x`` of the rank ``offset`` places before this one (mod the
    group's size); this rank's ``x`` goes to the rank ``offset`` after:
    one send and one receive."""
    S, r = dist.get_world_size(group), dist.get_rank(group)
    dev = x.device
    buf = x.detach().contiguous()
    staged = _staged(buf, group)
    if staged:
        buf = buf.cpu()
    out = torch.empty_like(buf)
    dst = dist.get_global_rank(group, (r + offset) % S)
    src = dist.get_global_rank(group, (r - offset) % S)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    stats["bytes"] += buf.numel() * buf.element_size()
    return out.to(dev) if staged else out


@_timed
def _broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (the others' values are
    not read): one ``broadcast``."""
    dev = x.device
    staged = _staged(x, group)
    # a copy: the broadcast writes into it
    buf = x.detach().cpu() if staged else x.detach().clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    stats["bytes"] += buf.numel() * buf.element_size()
    return buf.to(dev) if staged else buf


def _ordered_sum(x: torch.Tensor, group) -> torch.Tensor:
    parts = _gather(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _front(x: torch.Tensor, bdim):
    """x with its vmapped axis ``bdim`` moved to the front."""
    return x if bdim == 0 else x.movedim(bdim, 0)


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: the ordered sum over the group. Backward: identity (a
    replicated consumer)."""

    @staticmethod
    def forward(x, group):
        return _ordered_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _ReduceFromGroup.apply(x, group), None
        return _ReduceFromGroup.apply(_front(x, in_dims[0]), group), 0


class _CopyToGroup(torch.autograd.Function):
    """Forward: identity. Backward: the ordered sum over the group (each
    rank's cotangent covers only its own slice of the product)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromGroup.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToGroup.apply(x, group), in_dims[0]


class _SumPartial(torch.autograd.Function):
    """Forward: the ordered sum over the group. Backward: the ordered sum
    of the ranks' cotangents (each rank's loss is a partial)."""

    @staticmethod
    def forward(x, group):
        return _ordered_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _SumPartial.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _SumPartial.apply(x, group), None
        return _SumPartial.apply(_front(x, in_dims[0]), group), 0


class _Stack(torch.autograd.Function):
    """Forward: [S, *x.shape], every rank's x in rank order. Backward (a
    partial loss): the ordered sum of the ranks' cotangents at this
    rank's row."""

    @staticmethod
    def forward(x, group):
        return torch.stack(_gather(x, group))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _SumPartial.apply(g, ctx.group)[dist.get_rank(ctx.group)], None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _Stack.apply(x, group), None
        return _Stack.apply(_front(x, in_dims[0]), group), 1


class _AllGather(torch.autograd.Function):
    """Forward: the group's tensors concatenated along ``dim`` in rank
    order. Backward (a partial loss): the reduce-scatter, the ordered sum
    of the ranks' cotangents cut to this rank's block."""

    @staticmethod
    def forward(x, group, dim):
        return torch.cat(_gather(x, group), dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.group, ctx.dim = inputs
        ctx.n = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return _SumPartial.apply(g, ctx.group).narrow(ctx.dim, r * ctx.n, ctx.n), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        if in_dims[0] is None:
            return _AllGather.apply(x, group, dim), None
        return _AllGather.apply(_front(x, in_dims[0]), group, dim + 1), 0


class _Shift(torch.autograd.Function):
    """Forward: the tensor of the rank ``offset`` places before (mod S).
    Backward: the cotangent goes back ``offset`` places (the transpose of
    a permutation is its inverse)."""

    @staticmethod
    def forward(x, group, offset):
        return _shift(x, group, offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.offset = inputs

    @staticmethod
    def backward(ctx, g):
        return _Shift.apply(g, ctx.group, -ctx.offset), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, offset):
        if in_dims[0] is None:
            return _Shift.apply(x, group, offset), None
        return _Shift.apply(_front(x, in_dims[0]), group, offset), 0


class _BroadcastFrom(torch.autograd.Function):
    """Forward: group rank ``src``'s tensor on every rank. Backward: the
    source rank's own cotangent on the source, zeros elsewhere (the
    ranks' loss is replicated: their cotangents are equal, and the output
    is counted once)."""

    @staticmethod
    def forward(x, group, src):
        return _broadcast(x, group, src)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.src = inputs

    @staticmethod
    def backward(ctx, g):
        if dist.get_rank(ctx.group) == ctx.src:
            return g, None, None
        return torch.zeros_like(g), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, src):
        if in_dims[0] is None:
            return _BroadcastFrom.apply(x, group, src), None
        return _BroadcastFrom.apply(_front(x, in_dims[0]), group, src), 0


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def copy_to_group(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's f: identity forward, the group's ordered sum backward."""
    return _CopyToGroup.apply(x, axis.group)


def reduce_from_group(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's g: the group's ordered sum forward, identity backward."""
    return _ReduceFromGroup.apply(x, axis.group)


def sum_partial(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The group's ordered sum, forward and backward (partial losses)."""
    return _SumPartial.apply(x, axis.group)


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in rank order;
    backward the reduce-scatter (partial losses)."""
    return _AllGather.apply(x, axis.group, _dim(x, dim))


def stack(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[S, *x.shape]: every rank's ``x`` in rank order."""
    return _Stack.apply(x, axis.group)


def shift(x: torch.Tensor, axis: Axis, offset: int = 1) -> torch.Tensor:
    """Send ``x`` ``offset`` ranks on (mod S) and return the tensor of the
    rank ``offset`` before: the ring's step (``jax.lax.ppermute`` with
    the permutation i -> i + offset)."""
    return _Shift.apply(x, axis.group, offset)


def broadcast_from(x: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank; its backward counts the
    (replicated) cotangent once, on ``src``."""
    return _BroadcastFrom.apply(x, axis.group, src)
