"""Plain float32 forwards and losses of the benchmark's models, written
from their published descriptions: no kernels of the program, no
batching over clients, no caches.

- ResNet-9 (cifar10-fast): prep conv 64, conv 128 + max pool 2, a residual
  pair at 128, conv 256 + max pool 2, conv 512 + max pool 2, a residual
  pair at 512, max pool 4, a linear layer, logits scaled by 0.125. Every
  convolution is 3x3, padding 1, no bias, followed by batch norm and relu.
  Batch norm in training mode normalises with the batch's own statistics
  as flax's ``BatchNorm`` computes them (the variance E[x^2] - E[x]^2,
  clamped at 0; epsilon 1e-5).
- GPT-2 (openai-community/gpt2): token and position embeddings, the token
  type ids embedded through the token table, pre-norm blocks (causal
  multi-head attention, a 4x MLP with the tanh GELU), a final layer norm
  and the head tied to the token table. No dropout (the configuration
  runs at 0).

Each loss takes one client's batch and returns (mean loss, loss sum,
count): the mean is what the client differentiates, the sums are what the
round reports.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _conv_bn(p: dict, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = F.conv2d(x, p[f"{name}.conv.weight"], padding=1)
    mean = y.mean((0, 2, 3))
    var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    scale = torch.rsqrt(var + eps) * p[f"{name}.bn.weight"]
    y = (y - mean[:, None, None]) * scale[:, None, None] + p[f"{name}.bn.bias"][:, None, None]
    return F.relu(y)


def resnet9_logits(p: dict, x_nhwc: torch.Tensor, logit_scale: float = 0.125) -> torch.Tensor:
    x = x_nhwc.permute(0, 3, 1, 2)
    x = _conv_bn(p, "prep", x)
    x = F.max_pool2d(_conv_bn(p, "layer1", x), 2)
    x = x + _conv_bn(p, "res1.b", _conv_bn(p, "res1.a", x))
    x = F.max_pool2d(_conv_bn(p, "layer2", x), 2)
    x = F.max_pool2d(_conv_bn(p, "layer3", x), 2)
    x = x + _conv_bn(p, "res2.b", _conv_bn(p, "res2.a", x))
    x = F.max_pool2d(x, 4).flatten(1)
    return (x @ p["linear.weight"].t() + p["linear.bias"]) * logit_scale


def resnet9_loss(p: dict, batch: dict, cfg: dict):
    logits = resnet9_logits(p, batch["x"], cfg["logit_scale"])
    per_ex = -F.log_softmax(logits, -1).gather(1, batch["y"].long()[:, None])[:, 0]
    loss_sum = per_ex.sum()
    count = torch.tensor(float(per_ex.numel()), dtype=torch.float64)
    return loss_sum / per_ex.numel(), loss_sum, count


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def gpt2_logits(p: dict, ids: torch.Tensor, types: torch.Tensor, cfg: dict) -> torch.Tensor:
    B, T = ids.shape
    C, H = cfg["n_embd"], cfg["n_head"]
    hd, eps = C // H, cfg["layer_norm_epsilon"]
    wte = p["wte"]
    x = wte[ids.long()] + p["wpe"][:T][None] + wte[types.long()]
    causal = torch.ones(T, T, dtype=torch.bool, device=ids.device).tril()
    for i in range(cfg["n_layer"]):
        h = f"h_{i}"
        a = _layer_norm(x, p[f"{h}.ln_1.weight"], p[f"{h}.ln_1.bias"], eps)
        qkv = a @ p[f"{h}.attn.c_attn.weight"].t() + p[f"{h}.attn.c_attn.bias"]
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in qkv.split(C, -1))
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
        y = (att @ v).transpose(1, 2).reshape(B, T, C)
        x = x + y @ p[f"{h}.attn.c_proj.weight"].t() + p[f"{h}.attn.c_proj.bias"]
        m = _layer_norm(x, p[f"{h}.ln_2.weight"], p[f"{h}.ln_2.bias"], eps)
        f = _gelu_tanh(m @ p[f"{h}.mlp.c_fc.weight"].t() + p[f"{h}.mlp.c_fc.bias"])
        x = x + f @ p[f"{h}.mlp.c_proj.weight"].t() + p[f"{h}.mlp.c_proj.bias"]
    x = _layer_norm(x, p["ln_f.weight"], p["ln_f.bias"], eps)
    return x @ wte.t()


def gpt2_loss(p: dict, batch: dict, cfg: dict):
    """Next-token cross entropy over the labelled positions (labels -100
    are ignored): the logits at t predict the label at t + 1."""
    logits = gpt2_logits(p, batch["input_ids"], batch["token_type_ids"], cfg)[:, :-1]
    labels = batch["labels"].long()[:, 1:]
    mask = labels != -100
    logp = F.log_softmax(logits, -1)
    per_tok = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    loss_sum = (per_tok * mask).sum()
    count = mask.sum()
    return loss_sum / count.clamp_min(1), loss_sum, count.to(torch.float64)


LOSSES = {"resnet9": resnet9_loss, "gpt2": gpt2_loss}
