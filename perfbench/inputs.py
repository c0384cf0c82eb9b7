"""The benchmark's inputs, made from ``--seed`` on the device in a few
large calls: the federated data set and the initial flat parameters.

Both sides of the check get the same arrays: the system under test takes
the data set and the parameters as its inputs, and the reference reads
the same ones.
"""

from __future__ import annotations

import torch

from .reference import layout as rlayout

_DATA_STREAM = 0x5DEECE66D


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_data(model_cfg: dict, seed: int, device: torch.device) -> dict:
    """Host numpy arrays of the whole training set.

    - images: ``num_examples`` NHWC float32 images of N(0, 1) pixels and
      uniform labels.
    - text: ``num_clients * rows_per_client`` rows of ``seq_len`` token ids
      uniform over the vocabulary; each row's reply starts at a position
      drawn in [seq_len / 2, seq_len - 8), the prompt is typed with the
      vocabulary's second-last id and the reply with its last, and the
      labels are the reply's ids (-100 elsewhere)."""
    d = model_cfg["data"]
    gen = _gen(device, seed ^ _DATA_STREAM)
    if d["kind"] == "images":
        n = d["num_examples"]
        x = torch.randn((n, *d["shape"]), generator=gen, device=device)
        y = torch.randint(0, model_cfg["num_classes"], (n,), generator=gen, device=device)
        return {"x": x.cpu().numpy(), "y": y.to(torch.int32).cpu().numpy()}
    V, T = model_cfg["vocab_size"], d["seq_len"]
    n = d["num_clients"] * d["rows_per_client"]
    ids = torch.randint(0, V, (n, T), generator=gen, device=device, dtype=torch.int32)
    start = torch.randint(T // 2, T - 8, (n, 1), generator=gen, device=device)
    reply = torch.arange(T, device=device)[None, :] >= start
    types = torch.where(reply, V - 1, V - 2).to(torch.int32)
    labels = torch.where(reply, ids, -100).to(torch.int32)
    return {"input_ids": ids.cpu().numpy(), "token_type_ids": types.cpu().numpy(),
            "labels": labels.cpu().numpy()}


def init_std(leaf: rlayout.Leaf) -> tuple[float, float]:
    """(standard deviation, constant) of a leaf's initial values: lecun
    normal (1 / fan_in) for convolution and dense kernels, N(0, 0.02) for
    the token table and N(0, 0.01) for the position table, 1 for norm
    scales and 0 for biases."""
    if leaf.kind in ("conv", "linear"):
        return leaf.fan_in ** -0.5, 0.0
    if leaf.kind == "embedding":
        return (0.02 if leaf.name == "wte" else 0.01), 0.0
    if leaf.kind == "norm":
        return 0.0, 1.0
    return 0.0, 0.0


def make_weights(model_cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The flat float32 [d] initial parameters, in the reference layout's
    order: one normal draw scaled by each leaf's deviation, plus each
    leaf's constant."""
    leaves = rlayout.leaves(model_cfg)
    sizes = torch.tensor([leaf.size for leaf in leaves], device=device)
    std, const = zip(*(init_std(leaf) for leaf in leaves))
    std = torch.repeat_interleave(torch.tensor(std, device=device), sizes)
    const = torch.repeat_interleave(torch.tensor(const, device=device), sizes)
    d = int(sizes.sum())
    return torch.randn(d, generator=_gen(device, seed), device=device) * std + const
