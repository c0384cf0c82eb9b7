"""Carry model weights between the JAX package's flax layout and the port's,
and define the port's flat parameter vector, for ResNet-9 and the FEMNIST
CNN.

The sketch hashes coordinate *indices*, so the flat [d] vector the port
sketches must be exactly ``jax.flatten_util.ravel_pytree``'s: leaves in
sorted-key order of the flax parameter tree (ResNet-9:
``ConvBN_0/BatchNorm_0/bias``, ``.../scale``, ``ConvBN_0/Conv_0/kernel``,
..., ``Dense_0``, ``Residual_0``, ``Residual_1``; FEMNIST: ``Conv_0/bias``,
``Conv_0/kernel``, ``Conv_1``, ``Dense_0``, ``Dense_1``), each leaf
flattened row-major in flax's layout: conv kernels HWIO, dense kernels
[in, out]. A wrong order would silently change every top-k. ``FlatLayout``
holds that order and converts between the flat vector and the port's
parameters (OIHW convs, [out, in] linear).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

# port module name -> flax submodule name (ResNet-9, then the FEMNIST CNN)
_MODULE_NAMES = {
    "prep": "ConvBN_0", "layer1": "ConvBN_1", "res1": "Residual_0",
    "layer2": "ConvBN_2", "layer3": "ConvBN_3", "res2": "Residual_1",
    "linear": "Dense_0", "a": "ConvBN_0", "b": "ConvBN_1",
    "conv": "Conv_0", "bn": "BatchNorm_0",
    "conv1": "Conv_0", "conv2": "Conv_1", "dense1": "Dense_0", "dense2": "Dense_1",
}
# the kind of layer a port module is
_KINDS = {"conv": "conv", "conv1": "conv", "conv2": "conv", "bn": "bn",
          "linear": "linear", "dense1": "linear", "dense2": "linear"}
# (layer kind, port leaf name) -> flax leaf name
_LEAF_NAMES = {
    ("conv", "weight"): "kernel", ("conv", "bias"): "bias",
    ("bn", "weight"): "scale", ("bn", "bias"): "bias",
    ("bn", "running_mean"): "mean", ("bn", "running_var"): "var",
    ("linear", "weight"): "kernel", ("linear", "bias"): "bias",
}


def flax_path(name: str) -> tuple[str, ...]:
    """Port parameter/buffer name -> flax path, e.g.
    "res1.a.conv.weight" -> ("Residual_0", "ConvBN_0", "Conv_0", "kernel"),
    "dense1.bias" -> ("Dense_0", "bias")."""
    parts = name.split(".")
    return (*(_MODULE_NAMES[p] for p in parts[:-1]),
            _LEAF_NAMES[(_KINDS[parts[-2]], parts[-1])])


def _to_flax_perm(shape: tuple[int, ...]) -> tuple[int, ...] | None:
    """Axis permutation taking a port weight to flax layout (None: same)."""
    if len(shape) == 4:
        return (2, 3, 1, 0)  # OIHW -> HWIO
    if len(shape) == 2:
        return (1, 0)  # [out, in] -> [in, out]
    return None


def _inverse(perm: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(perm))


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str  # port parameter name
    shape: tuple[int, ...]  # port layout
    perm: tuple[int, ...] | None  # port -> flax axis permutation
    offset: int  # start in the flat vector
    size: int

    @property
    def flax_shape(self) -> tuple[int, ...]:
        return self.shape if self.perm is None else tuple(self.shape[i] for i in self.perm)


def flat_order(model: nn.Module) -> list[Leaf]:
    """The model's parameters in ravel_pytree order, with their offsets."""
    named = sorted(model.named_parameters(), key=lambda kv: flax_path(kv[0]))
    leaves, offset = [], 0
    for name, p in named:
        shape = tuple(p.shape)
        leaves.append(Leaf(name, shape, _to_flax_perm(shape), offset, p.numel()))
        offset += p.numel()
    return leaves


class FlatLayout:
    """Flat [d] vector (ravel_pytree order and layout) <-> the port's
    parameter dict (port names, port layouts)."""

    def __init__(self, model: nn.Module):
        self.leaves = flat_order(model)
        self.d = sum(leaf.size for leaf in self.leaves)

    def flatten(self, params: dict[str, torch.Tensor]) -> torch.Tensor:
        parts = []
        for leaf in self.leaves:
            t = params[leaf.name]
            if leaf.perm is not None:
                t = t.permute(leaf.perm)
            parts.append(t.reshape(-1))
        return torch.cat(parts)

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        if tuple(flat.shape) != (self.d,):
            raise ValueError(f"expected a flat [{self.d}] vector, got {tuple(flat.shape)}")
        out = {}
        for leaf in self.leaves:
            t = flat[leaf.offset:leaf.offset + leaf.size].view(leaf.flax_shape)
            if leaf.perm is not None:
                t = t.permute(_inverse(leaf.perm))
            out[leaf.name] = t.contiguous()
        return out


def _lookup(tree: dict, path: tuple[str, ...]) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def params_from_flax(model: nn.Module, params_np: dict, batch_stats_np: dict,
                     device: torch.device | str = "cpu"
                     ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """The JAX package's ``params`` and ``batch_stats`` (nested dicts of
    numpy arrays; ``{}`` for a model without batch norm) -> the port's
    (params, net_state) dicts keyed by the model's parameter and buffer
    names, in the port's layouts."""
    params = {}
    for name, p in model.named_parameters():
        a = _lookup(params_np, flax_path(name))
        perm = _to_flax_perm(tuple(p.shape))
        if perm is not None:
            a = a.transpose(_inverse(perm))
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: flax shape {a.shape} does not fit {tuple(p.shape)}")
        params[name] = torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    net_state = {name: torch.tensor(_lookup(batch_stats_np, flax_path(name)),
                                    dtype=torch.float32, device=device)
                 for name, _ in model.named_buffers()}
    return params, net_state
