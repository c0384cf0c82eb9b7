"""The flat parameter vector of the benchmark's models, worked out from the
published model structure alone.

FetchSGD sketches coordinate indices, so the order of the flat vector is
part of the algorithm: it is the order in which ``jax.flatten_util``
ravels a flax parameter tree, leaves sorted by their path, each leaf
row-major in flax's layout (convolution kernels HWIO, dense kernels
[in, out]). A ``Leaf`` holds a parameter's name in the PyTorch module
layout (convolutions OIHW, linear weights [out, in]), its shape there, and
its place in the flat vector. ``unflatten`` turns a flat vector into the
PyTorch-layout tensors the reference models compute with.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# ResNet-9's module names and the flax submodule each stands for
_RESNET9_MODULES = {"prep": "ConvBN_0", "layer1": "ConvBN_1", "res1": "Residual_0",
                    "layer2": "ConvBN_2", "layer3": "ConvBN_3", "res2": "Residual_1",
                    "linear": "Dense_0", "a": "ConvBN_0", "b": "ConvBN_1",
                    "conv": "Conv_0", "bn": "BatchNorm_0"}
_LEAF = {"weight": "kernel", "bias": "bias"}
_NORM_LEAF = {"weight": "scale", "bias": "bias"}


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str  # PyTorch-layout parameter name
    shape: tuple  # PyTorch layout
    kind: str  # "conv", "linear", "norm", "bias", "embedding"
    offset: int
    size: int

    @property
    def flax_shape(self) -> tuple:
        if self.kind == "conv":  # OIHW -> HWIO
            o, i, h, w = self.shape
            return (h, w, i, o)
        if self.kind == "linear":  # [out, in] -> [in, out]
            return (self.shape[1], self.shape[0])
        return self.shape

    @property
    def fan_in(self) -> int:
        return math.prod(self.shape[1:])


def _resnet9_params(num_classes: int) -> list[tuple[str, tuple, str, tuple]]:
    """(name, shape, kind, flax path) of every ResNet-9 parameter."""
    out = []

    def convbn(prefix: list[str], cin: int, cout: int):
        flax = [_RESNET9_MODULES[p] for p in prefix]
        name = ".".join(prefix)
        out.append((f"{name}.conv.weight", (cout, cin, 3, 3), "conv",
                    (*flax, "Conv_0", "kernel")))
        out.append((f"{name}.bn.weight", (cout,), "norm", (*flax, "BatchNorm_0", "scale")))
        out.append((f"{name}.bn.bias", (cout,), "bias", (*flax, "BatchNorm_0", "bias")))

    convbn(["prep"], 3, 64)
    convbn(["layer1"], 64, 128)
    convbn(["res1", "a"], 128, 128)
    convbn(["res1", "b"], 128, 128)
    convbn(["layer2"], 128, 256)
    convbn(["layer3"], 256, 512)
    convbn(["res2", "a"], 512, 512)
    convbn(["res2", "b"], 512, 512)
    out.append(("linear.weight", (num_classes, 512), "linear", ("Dense_0", "kernel")))
    out.append(("linear.bias", (num_classes,), "bias", ("Dense_0", "bias")))
    return out


def _gpt2_params(cfg: dict) -> list[tuple[str, tuple, str, tuple]]:
    """(name, shape, kind, flax path) of every GPT-2 parameter: a tied head,
    so the token embedding is the output projection too."""
    C, V, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
    out = [("wte", (V, C), "embedding", ("wte",)), ("wpe", (P, C), "embedding", ("wpe",))]
    for i in range(cfg["n_layer"]):
        h = f"h_{i}"
        for mod, sub, cin, cout in (("attn", "c_attn", C, 3 * C), ("attn", "c_proj", C, C),
                                    ("mlp", "c_fc", C, 4 * C), ("mlp", "c_proj", 4 * C, C)):
            out.append((f"{h}.{mod}.{sub}.weight", (cout, cin), "linear",
                        (h, mod, sub, "kernel")))
            out.append((f"{h}.{mod}.{sub}.bias", (cout,), "bias", (h, mod, sub, "bias")))
        for ln in ("ln_1", "ln_2"):
            out.append((f"{h}.{ln}.weight", (C,), "norm", (h, ln, "scale")))
            out.append((f"{h}.{ln}.bias", (C,), "bias", (h, ln, "bias")))
    out.append(("ln_f.weight", (C,), "norm", ("ln_f", "scale")))
    out.append(("ln_f.bias", (C,), "bias", ("ln_f", "bias")))
    return out


def leaves(model_cfg: dict) -> list[Leaf]:
    """The flat vector's leaves, in ravel order, for a configuration file's
    model block."""
    if model_cfg["model"] == "resnet9":
        params = _resnet9_params(model_cfg["num_classes"])
    elif model_cfg["model"] == "gpt2":
        params = _gpt2_params(model_cfg)
    else:
        raise ValueError(f"unknown model {model_cfg['model']!r}")
    out, offset = [], 0
    for name, shape, kind, _ in sorted(params, key=lambda p: p[3]):
        size = math.prod(shape)
        out.append(Leaf(name, shape, kind, offset, size))
        offset += size
    return out


def unflatten(flat: torch.Tensor, layout: list[Leaf]) -> dict[str, torch.Tensor]:
    """PyTorch-layout tensors of a flat vector (copies)."""
    out = {}
    for leaf in layout:
        t = flat[leaf.offset:leaf.offset + leaf.size].view(leaf.flax_shape)
        if leaf.kind == "conv":
            t = t.permute(3, 2, 0, 1)
        elif leaf.kind == "linear":
            t = t.t()
        out[leaf.name] = t.contiguous()
    return out


def flatten(params: dict[str, torch.Tensor], layout: list[Leaf]) -> torch.Tensor:
    """The flat vector of PyTorch-layout tensors (the inverse of
    ``unflatten``)."""
    parts = []
    for leaf in layout:
        t = params[leaf.name]
        if leaf.kind == "conv":
            t = t.permute(2, 3, 1, 0)
        elif leaf.kind == "linear":
            t = t.t()
        parts.append(t.reshape(-1))
    return torch.cat(parts)


def leaf_norms(flat: torch.Tensor, layout: list[Leaf]) -> list[float]:
    """The Euclidean norm of each leaf's slice of a flat vector, in float64."""
    f = flat.to(torch.float64)
    return [float(f[leaf.offset:leaf.offset + leaf.size].norm()) for leaf in layout]
