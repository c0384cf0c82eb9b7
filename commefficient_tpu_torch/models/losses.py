"""Loss functions binding a model to the engine's protocol:
``loss_fn(params, net_state, batch) -> (loss, aux)``, the twin of the JAX
package's ``models/losses.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call


def make_classification_loss(model: nn.Module, train: bool):
    """Masked softmax cross-entropy for image classifiers with batch-norm
    state. ``params``/``net_state`` are the model's parameter and buffer
    dicts; batch = {"x": [B, H, W, C], "y": [B] int, "mask": [B] 0/1}.
    Metrics are sums (loss_sum, count, correct) so they add across clients
    and batches. In train mode ``aux["net_state"]`` holds the updated
    running statistics; in eval mode it is ``net_state`` unchanged."""

    def loss_fn(params: dict, net_state: dict, batch: dict):
        logits, new_stats = functional_call(
            model, {**params, **net_state}, (batch["x"],), {"train": train})
        new_net_state = new_stats if train else net_state
        logp = F.log_softmax(logits, dim=-1)
        per_ex = -logp.gather(1, batch["y"].long()[:, None])[:, 0]
        mask = batch["mask"].to(per_ex.dtype)
        loss_sum = (per_ex * mask).sum()
        loss = loss_sum / mask.sum().clamp_min(1.0)
        correct = ((logits.argmax(-1) == batch["y"]).to(mask.dtype) * mask).sum()
        return loss, {
            "net_state": new_net_state,
            "metrics": {"loss_sum": loss_sum, "count": mask.sum(), "correct": correct},
        }

    return loss_fn
