"""Carry model weights between the JAX package's flax layout and the port's,
and define the port's flat parameter vector, for ResNet-9, the FEMNIST CNN
and GPT-2.

The sketch hashes coordinate *indices*, so the flat [d] vector the port
sketches must be exactly ``jax.flatten_util.ravel_pytree``'s: leaves in
sorted-key order of the flax parameter tree (ResNet-9:
``ConvBN_0/BatchNorm_0/bias``, ``.../scale``, ``ConvBN_0/Conv_0/kernel``,
..., ``Dense_0``, ``Residual_0``, ``Residual_1``; FEMNIST: ``Conv_0/bias``,
``Conv_0/kernel``, ``Conv_1``, ``Dense_0``, ``Dense_1``; GPT-2: ``h_0``,
``h_1``, ``h_10``, ``h_11``, ``h_2``, ..., ``ln_f``, then ``mc_head`` when
the model has the classification head, ``wpe``, ``wte``; within a block
``attn``, ``ln_1``, ``ln_2``, then ``mlp`` or the mixture of experts'
``moe_mlp/router``, ``wi``, ``wo``), each
leaf flattened row-major in flax's layout: conv kernels HWIO, dense kernels
[in, out]. A wrong order would silently change every top-k. ``FlatLayout``
holds that order and converts between the flat vector and the port's
parameters (OIHW convs, [out, in] linear). A leaf's permutation follows from
the kind of layer that owns it: a raw parameter such as GPT-2's ``wte``
[vocab, n_embd], or a mixture of experts' ``router``, ``wi`` or ``wo``, has
one layout in both packages and is never transposed.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
from torch import nn

# port module name -> flax submodule name (ResNet-9, then the FEMNIST CNN;
# GPT-2's modules carry the flax names, see _GPT2_MODULES)
_MODULE_NAMES = {
    "prep": "ConvBN_0", "layer1": "ConvBN_1", "res1": "Residual_0",
    "layer2": "ConvBN_2", "layer3": "ConvBN_3", "res2": "Residual_1",
    "linear": "Dense_0", "a": "ConvBN_0", "b": "ConvBN_1",
    "conv": "Conv_0", "bn": "BatchNorm_0",
    "conv1": "Conv_0", "conv2": "Conv_1", "dense1": "Dense_0", "dense2": "Dense_1",
}
_GPT2_MODULES = {"attn", "mlp", "moe_mlp", "c_attn", "c_proj", "c_fc", "ln_1", "ln_2",
                 "ln_f"}
_GPT2_BLOCK = re.compile(r"h_\d+")
# the kind of layer a port module is; a parameter of the model itself (no
# module) is "raw"
_KINDS = {"conv": "conv", "conv1": "conv", "conv2": "conv", "bn": "bn",
          "linear": "linear", "dense1": "linear", "dense2": "linear",
          "c_attn": "linear", "c_proj": "linear", "c_fc": "linear",
          "ln_1": "ln", "ln_2": "ln", "ln_f": "ln", "moe_mlp": "moe"}
# (layer kind, port leaf name) -> flax leaf name
_LEAF_NAMES = {
    ("conv", "weight"): "kernel", ("conv", "bias"): "bias",
    ("bn", "weight"): "scale", ("bn", "bias"): "bias",
    ("bn", "running_mean"): "mean", ("bn", "running_var"): "var",
    ("linear", "weight"): "kernel", ("linear", "bias"): "bias",
    ("ln", "weight"): "scale", ("ln", "bias"): "bias",
    ("raw", "wte"): "wte", ("raw", "wpe"): "wpe", ("raw", "mc_head"): "mc_head",
    ("moe", "router"): "router", ("moe", "wi"): "wi", ("moe", "wo"): "wo",
}
# the axis permutation taking the kernel of a conv or dense layer (flax leaf
# "kernel") from the port's layout to flax's, by its rank; every other leaf
# (biases, norm scales, embedding tables) has one layout in both
_KERNEL_PERMS = {4: (2, 3, 1, 0),  # conv OIHW -> HWIO
                 2: (1, 0)}  # linear [out, in] -> [in, out]


def _module_name(part: str) -> str:
    if part in _GPT2_MODULES or _GPT2_BLOCK.fullmatch(part):
        return part
    return _MODULE_NAMES[part]


def flax_path(name: str) -> tuple[str, ...]:
    """Port parameter/buffer name -> flax path, e.g.
    "res1.a.conv.weight" -> ("Residual_0", "ConvBN_0", "Conv_0", "kernel"),
    "h_3.attn.c_attn.weight" -> ("h_3", "attn", "c_attn", "kernel"),
    "h_1.moe_mlp.wi" -> ("h_1", "moe_mlp", "wi"), "wte" -> ("wte",)."""
    *modules, leaf = name.split(".")
    kind = _KINDS[modules[-1]] if modules else "raw"
    return (*(_module_name(p) for p in modules), _LEAF_NAMES[(kind, leaf)])


def _to_flax_perm(name: str, shape: tuple[int, ...]) -> tuple[int, ...] | None:
    """Axis permutation taking the port parameter ``name`` of ``shape`` to
    flax layout (None: the same layout). It follows from the kind of layer
    that owns the leaf: only a conv or dense kernel is permuted, never a
    raw parameter such as GPT-2's [vocab, n_embd] ``wte``."""
    return _KERNEL_PERMS[len(shape)] if flax_path(name)[-1] == "kernel" else None


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
        leaves.append(Leaf(name, shape, _to_flax_perm(name, shape), offset, p.numel()))
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
        perm = _to_flax_perm(name, tuple(p.shape))
        if perm is not None:
            a = a.transpose(_inverse(perm))
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: flax shape {a.shape} does not fit {tuple(p.shape)}")
        params[name] = torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    net_state = {name: torch.tensor(_lookup(batch_stats_np, flax_path(name)),
                                    dtype=torch.float32, device=device)
                 for name, _ in model.named_buffers()}
    return params, net_state
