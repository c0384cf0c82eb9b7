"""Pretrained GPT-2 weights from a HuggingFace checkpoint: the port's twin
of the JAX package's ``models/gpt2_loader.py``.

A checkpoint is a directory (``config.json`` beside ``pytorch_model.bin``
or ``model.safetensors``) or one of those files. ``pytorch_model.bin`` is
read with ``torch.load(weights_only=True)``; ``model.safetensors`` with a
reader of the format written here with the standard library (the port
imports no ``safetensors`` and no ``transformers``): an 8-byte
little-endian header length, a JSON header of {name: {"dtype", "shape",
"data_offsets"}}, then the raw tensors.

HF's GPT-2 names (``transformer.`` stripped) map onto the flax parameter
tree the reference builds: HF's Conv1D weights are [in, out] as flax's
Dense kernels are, ``c_attn`` packs Q|K|V on the output axis, the LM head is
tied to ``wte``. The port's parameters then come from that tree through
``convert.params_from_flax``, which owns every transposition ([in, out] ->
``nn.Linear``'s [out, in]).

The vocabulary grows to the dialog special tokens: new ``wte`` rows are the
mean pretrained row plus 0.02 x ``RandomState(0)`` standard normals (the
same rows at every load). ``wpe`` is sliced to ``n_positions``. Shrinking
the vocabulary or growing the positions is refused.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from .convert import params_from_flax
from .gpt2 import GPT2Config, GPT2LMHead

# safetensors dtype names the reader takes, and their torch dtypes
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """{name: tensor} of a ``.safetensors`` file, in the file's dtypes
    (F32, F16 or BF16; another dtype raises)."""
    blob = bytearray(os.path.getsize(path))  # writable, as torch.frombuffer wants
    with open(path, "rb") as f:
        f.readinto(blob)
    (n,) = struct.unpack("<Q", blob[:8])
    header = json.loads(blob[8:8 + n])
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; the reader takes "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {name}'s data_offsets do not fit its shape")
        t = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"]).clone()
    return out


def _read_state_dict(path: str) -> dict[str, np.ndarray]:
    """{name: float32 ndarray} from a checkpoint file or directory."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no pytorch_model.bin / model.safetensors under {path}")
    if path.endswith(".safetensors"):
        raw = read_safetensors(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
    return {k: v.to(torch.float32).numpy() for k, v in raw.items()}


def _read_config(path: str) -> dict:
    cfg_path = os.path.join(path, "config.json")
    if os.path.isdir(path) and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return json.load(f)
    return {}


def _flax_tree(path: str, target_vocab_size: int | None = None,
               n_positions: int | None = None,
               dtype: str = "float32") -> tuple[dict, GPT2Config]:
    """(flax-layout parameter tree of float32 ndarrays, GPT2Config) of an
    HF GPT-2 checkpoint, as the reference's ``load_hf_gpt2`` returns it.
    ``target_vocab_size`` above the checkpoint's appends the new rows to
    ``wte``; ``n_positions`` at most the checkpoint's slices ``wpe``."""
    sd = {k.removeprefix("transformer."): v for k, v in _read_state_dict(path).items()}
    hf_cfg = _read_config(path)
    wte, wpe = sd["wte.weight"], sd["wpe.weight"]
    vocab, n_embd = wte.shape
    layers = sorted({int(k.split(".")[1]) for k in sd if k.startswith("h.")})
    n_layer = len(layers)
    if layers != list(range(n_layer)):
        raise ValueError(f"non-contiguous layer indices in checkpoint: {layers}")
    n_head = int(hf_cfg.get("n_head", 12))
    ln_eps = float(hf_cfg.get("layer_norm_epsilon", 1e-5))

    if target_vocab_size is None:
        target_vocab_size = vocab
    if target_vocab_size < vocab:
        raise ValueError(f"cannot shrink vocab {vocab} -> {target_vocab_size}")
    if target_vocab_size > vocab:
        extra = target_vocab_size - vocab
        mean = wte.mean(axis=0, keepdims=True)
        noise_rng = np.random.RandomState(0)
        new_rows = mean + 0.02 * noise_rng.standard_normal((extra, n_embd)).astype(np.float32)
        wte = np.concatenate([wte, new_rows], axis=0)
    if n_positions is None:
        n_positions = wpe.shape[0]
    if n_positions > wpe.shape[0]:
        raise ValueError(f"cannot extend positions {wpe.shape[0]} -> {n_positions}: GPT-2's "
                         "learned wpe has no values there")
    wpe = wpe[:n_positions]
    cfg = GPT2Config(vocab_size=target_vocab_size, n_positions=n_positions, n_embd=n_embd,
                     n_layer=n_layer, n_head=n_head, ln_eps=ln_eps, dtype=dtype)

    def leaf(prefix: str, weight: str) -> dict:
        return {weight: sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    tree: dict = {"wte": wte, "wpe": wpe, "ln_f": leaf("ln_f", "scale")}
    for i in range(n_layer):
        tree[f"h_{i}"] = {
            "ln_1": leaf(f"h.{i}.ln_1", "scale"),
            "ln_2": leaf(f"h.{i}.ln_2", "scale"),
            "attn": {"c_attn": leaf(f"h.{i}.attn.c_attn", "kernel"),
                     "c_proj": leaf(f"h.{i}.attn.c_proj", "kernel")},
            "mlp": {"c_fc": leaf(f"h.{i}.mlp.c_fc", "kernel"),
                    "c_proj": leaf(f"h.{i}.mlp.c_proj", "kernel")},
        }
    return tree, cfg


def load_hf_gpt2(path: str, target_vocab_size: int | None = None,
                 n_positions: int | None = None,
                 dtype: str = "float32") -> tuple[dict[str, torch.Tensor], GPT2Config]:
    """(the port's GPT-2 parameters on the CPU, GPT2Config) of an HF GPT-2
    checkpoint: ``_flax_tree``'s tree carried into the port's names
    and layouts by ``convert.params_from_flax``. The config has no mc head;
    a caller that wants one adds a fresh ``mc_head``."""
    tree, cfg = _flax_tree(path, target_vocab_size, n_positions, dtype)
    with torch.device("meta"):  # names and shapes only, nothing allocated
        model = GPT2LMHead(cfg)
    params, _ = params_from_flax(model, tree, {})
    return params, cfg
