"""The FEMNIST CNN, the PyTorch twin of the JAX package's
``models/femnist_cnn.py``: LEAF's 2-conv network for 62-class handwritten
characters on 28x28 inputs.

conv 5x5 x32 (pad 2) -> ReLU -> max-pool 2 -> conv 5x5 x64 (pad 2) -> ReLU
-> max-pool 2 -> dense 2048 -> ReLU -> dense 62; d = 6,603,710. No batch
norm, so ``new_stats`` is always empty.

The forward takes NHWC images, as the data layer produces them. The flatten
before ``dense1`` runs in (h, w, c) order, as flax flattens NHWC, so a flax
``Dense_0`` kernel of [3136, 2048] carries over unchanged (``convert.py``).
``dtype="bfloat16"`` runs the convolutions and dense layers in bfloat16
(input, kernels and biases cast) as the reference does; parameters and
logits stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FEMNISTCNN(nn.Module):
    def __init__(self, num_classes: int = 62, dtype: str = "float32"):
        super().__init__()
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        self.compute_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.dense1 = nn.Linear(7 * 7 * 64, 2048)
        self.dense2 = nn.Linear(2048, num_classes)

    def forward(self, x_nhwc: torch.Tensor, train: bool = True):
        """NHWC images -> (float32 logits [B, classes], {})."""
        dt = self.compute_dtype

        def conv(layer, x):
            return F.conv2d(x, layer.weight.to(dt), layer.bias.to(dt), padding=2)

        def dense(layer, x):
            return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))

        x = x_nhwc.permute(0, 3, 1, 2).to(dt)
        x = F.max_pool2d(F.relu(conv(self.conv1, x)), 2)
        x = F.max_pool2d(F.relu(conv(self.conv2, x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c) order
        return dense(self.dense2, F.relu(dense(self.dense1, x))).float(), {}
