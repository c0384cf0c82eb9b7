"""Pipeline parallelism: GPipe's microbatched stage schedule over a group
of ranks, one stage a rank: the port's twin of the JAX package's
``ops/pipeline.py``.

Layout:
- ``stage_params``: a pytree of this rank's stage, every leaf with a
  leading axis of 1 (this rank's slice of the [S] stage axis of
  ``stack_stages``: ``local_stage`` cuts it), so a rank holds only its
  stage's [L / S, ...] layers. ``stage_fn(params, x_mb) -> y_mb`` applies
  one stage (``scan_stage`` lifts a per-layer function); x_mb and y_mb
  have one shape.
- ``x``: [M, mb, ...] microbatches, the same on every rank (stage 0 reads
  them). Returns [M, mb, ...] on every rank.

Schedule: M + S - 1 steps. At step t stage 0 takes microbatch t (while
t < M), every stage applies its layers to the activation it holds, and
the activations move one stage on (``collectives.shift``, whose backward
moves the cotangents one stage back); the last stage's output at step t
is microbatch t - (S - 1). Every rank runs every step, so the ranks'
graphs have one shape and issue their collectives in one order, forward
and backward. The last stage's [M, mb, ...] output reaches every rank by
``collectives.broadcast_from``, whose backward hands the last stage its
cotangent once (the reference's masked ``psum`` transposes so; summing
the S ranks' equal cotangents would scale the stage gradients S times).
Backward is autograd's through these.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ..parallel import collectives


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   axis: collectives.Axis) -> torch.Tensor:
    """Run microbatches [M, mb, ...] through the S stages of the group
    ``axis`` (this rank is stage ``axis.index``); see module docstring."""
    S, stage = axis.size, axis.index
    M = x.shape[0]
    if M < 1:
        raise ValueError("need at least one microbatch")
    for leaf in pytree.tree_leaves(stage_params):
        if leaf.shape[0] != 1:
            raise ValueError(
                f"stage_params leading axis must be this rank's one slice of the {S}-stage "
                f"pipe axis, got {leaf.shape[0]} — per-layer stacks go through "
                "stack_stages(params, num_stages) and local_stage first")
    mine = pytree.tree_map(lambda a: a[0], stage_params)
    first = torch.tensor(stage == 0, device=x.device)
    buf = torch.zeros_like(x[0])
    outs = []
    for t in range(M + S - 1):
        # stage 0 takes microbatch t; the others keep what they were handed
        buf = torch.where(first, x[min(t, M - 1)], buf)
        y = stage_fn(mine, buf)
        if t >= S - 1:  # the last stage finished microbatch t - (S - 1)
            outs.append(y)
        if t < M + S - 2:
            buf = collectives.shift(y, axis)
    return collectives.broadcast_from(torch.stack(outs), axis, S - 1)


def stack_stages(per_layer_params, num_stages: int):
    """[L, ...] per-layer stacked params -> [S, L // S, ...] per-stage
    slices (stage s owns layers s * L // S .. (s + 1) * L // S - 1)."""

    def reshape(a):
        L = a.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers not divisible by {num_stages} stages")
        return a.reshape(num_stages, L // num_stages, *a.shape[1:])

    return pytree.tree_map(reshape, per_layer_params)


def local_stage(staged, axis: collectives.Axis):
    """This rank's [1, L // S, ...] slice of ``stack_stages``'s tree."""
    return pytree.tree_map(lambda a: a[axis.index:axis.index + 1], staged)


def scan_stage(layer_fn: Callable) -> Callable:
    """Lift a per-layer fn into a stage fn: applies the stage's [Lps, ...]
    layers in order to the activation."""

    def stage_fn(stage_params, x):
        n = pytree.tree_leaves(stage_params)[0].shape[0]
        for i in range(n):
            x = layer_fn(pytree.tree_map(lambda a: a[i], stage_params), x)
        return x

    return stage_fn
