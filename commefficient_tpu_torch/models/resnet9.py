"""ResNet-9 (the cifar10-fast lineage), the PyTorch twin of the JAX
package's ``models/resnet9.py``.

prep conv 64 -> conv 128 + pool -> Residual(128) -> conv 256 + pool ->
conv 512 + pool -> Residual(512) -> global max pool 4 -> linear, batch norm
after every conv, logits scaled by 0.125.

The public forward takes NHWC images, as the data layer produces them, and
permutes to NCHW inside. Every module's forward returns ``(output,
new_stats)``: in train mode the batch norms normalise with the batch's own
statistics and report the updated running statistics in ``new_stats``
(keyed like the module's buffers) instead of writing their buffers, so a
caller can run many clients from the same state and average their
statistics, as the federated round does.

Batch norm follows flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``, not
``nn.BatchNorm2d``: the running variance is updated with the *biased* batch
variance, computed as E[x^2] - E[x]^2 clamped at zero, over all B rows
(masked padding included), and the output is
``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

``dtype="bfloat16"`` computes as the reference does: the input is cast to
bfloat16 and each convolution runs in it; batch norm computes its
statistics and its output in float32 from the bfloat16 input; relu, then a
cast back to bfloat16, in which the residual adds and the max pools run;
the linear layer runs in bfloat16 and its output is cast to float32 before
the 0.125 scale. Parameters and running statistics stay float32. The
default, float32, is the reference's default ``--dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """flax-semantics batch norm over the channel axis of NCHW input."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool):
        """(float32 output, new running statistics) of ``x`` in any float
        dtype: the statistics and the output are computed in float32, as
        flax's ``BatchNorm(dtype=float32)`` does, the statistics from one
        cast of x and the normalisation from another (so that in bfloat16
        the backward rounds each cast's cotangent on its own, as JAX's
        does)."""
        new = {}
        if train:
            xs = x.float()
            mean = xs.mean((0, 2, 3))
            var = ((xs * xs).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            m = self.momentum
            new = {"running_mean": m * self.running_mean + (1 - m) * mean,
                   "running_var": m * self.running_var + (1 - m) * var}
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y, new


def _prefixed(prefix: str, stats: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in stats.items()}


class ConvBN(nn.Module):
    """Convolution in the input's dtype, batch norm in float32, relu, and
    the output back in the input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor, train: bool):
        y = F.conv2d(x, self.conv.weight.to(x.dtype), padding=1)
        y, stats = self.bn(y, train)
        return F.relu(y).to(x.dtype), _prefixed("bn", stats)


class Residual(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.a = ConvBN(features, features)
        self.b = ConvBN(features, features)

    def forward(self, x: torch.Tensor, train: bool):
        y, sa = self.a(x, train)
        y, sb = self.b(y, train)
        return x + y, {**_prefixed("a", sa), **_prefixed("b", sb)}


class ResNet9(nn.Module):
    def __init__(self, num_classes: int = 10, logit_scale: float = 0.125,
                 dtype: str = "float32"):
        super().__init__()
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        self.logit_scale = logit_scale
        self.compute_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.prep = ConvBN(3, 64)
        self.layer1 = ConvBN(64, 128)
        self.res1 = Residual(128)
        self.layer2 = ConvBN(128, 256)
        self.layer3 = ConvBN(256, 512)
        self.res2 = Residual(512)
        self.linear = nn.Linear(512, num_classes)

    def forward(self, x_nhwc: torch.Tensor, train: bool = True):
        """NHWC images -> (float32 logits [B, classes], new running stats)."""
        dt = self.compute_dtype
        x = x_nhwc.permute(0, 3, 1, 2).to(dt)
        stats = {}
        for name, pool in (("prep", 0), ("layer1", 2), ("res1", 0),
                           ("layer2", 2), ("layer3", 2), ("res2", 4)):
            x, s = getattr(self, name)(x, train)
            stats.update(_prefixed(name, s))
            if pool:
                x = F.max_pool2d(x, pool)
        x = x.reshape(x.shape[0], -1)
        logits = F.linear(x, self.linear.weight.to(dt), self.linear.bias.to(dt))
        return logits.float() * self.logit_scale, stats


def init_weights(model: nn.Module, seed: int) -> None:
    """Initialise in place like flax's defaults, from an explicit generator:
    conv and linear kernels lecun-normal (normal truncated at two standard
    deviations, variance 1 / fan_in), biases 0, batch-norm scales 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()  # OIHW: I*H*W; linear [out, in]: in
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
            elif name.endswith("bn.weight"):
                p.fill_(1.0)
            else:
                p.zero_()
