"""Loss functions binding a model to the engine's protocol:
``loss_fn(params, net_state, batch, gen=None) -> (loss, aux)``, the twin of
the JAX package's ``models/losses.py``. ``gen`` is the ``torch.Generator``
a training forward draws its dropout masks from, or the list of masks
that the loss's ``dropout_masks(batch, gen)`` drew from one beforehand
(what the engine passes under ``torch.func.vmap``, where nothing may
draw); None in eval. The classification losses ignore it and have no
``dropout_masks``. The LM losses are ``make_lm_loss`` and, for the
double-head objective, ``make_lm_mc_loss``."""

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

    def loss_fn(params: dict, net_state: dict, batch: dict, gen=None):
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


def make_lm_loss(model: nn.Module, train: bool):
    """Next-token cross-entropy for a causal LM (``models/gpt2.py``).

    batch = {"input_ids": [B, T] int, "labels": [B, T] int with -100 =
    ignore, optionally "token_type_ids": [B, T] int}. The logits at t
    predict the label at t + 1. Per-token losses come from ``log_softmax``
    and a gather: CUDA's ``nll_loss`` has no deterministic kernel and raises
    under ``torch.use_deterministic_algorithms``, which the entry point
    sets. Metrics are sums (loss_sum, count, correct) over the labelled
    tokens, so perplexity is exp(loss_sum / count) across clients and
    batches. There is no model state: ``aux["net_state"]`` is
    ``net_state``."""

    def loss_fn(params: dict, net_state: dict, batch: dict, gen=None):
        logits = functional_call(
            model, params, (batch["input_ids"],),
            {"train": train, "token_type_ids": batch.get("token_type_ids"), "gen": gen})
        logits = logits[:, :-1]
        labels = batch["labels"][:, 1:].long()
        mask = (labels != -100).to(logits.dtype)
        safe_labels = labels.clamp_min(0)
        logp = F.log_softmax(logits, dim=-1)
        per_tok = -logp.gather(-1, safe_labels[..., None])[..., 0]
        loss_sum = (per_tok * mask).sum()
        loss = loss_sum / mask.sum().clamp_min(1.0)
        correct = ((logits.argmax(-1) == safe_labels).to(mask.dtype) * mask).sum()
        return loss, {
            "net_state": net_state,
            "metrics": {"loss_sum": loss_sum, "count": mask.sum(), "correct": correct},
        }

    def dropout_masks(batch: dict, gen: torch.Generator) -> list:
        return model.dropout_masks(tuple(batch["input_ids"].shape), gen) if train else []

    loss_fn.dropout_masks = dropout_masks
    return loss_fn


def make_lm_mc_loss(model: nn.Module, train: bool, mc_coef: float = 1.0, pad_id: int = 0):
    """The double-head objective of transfer-learning-conv-ai (LM plus
    next-utterance classification), the twin of the reference's
    ``make_lm_mc_loss``, for a ``GPT2LMHead`` with ``with_mc_head``.

    batch = {"input_ids", "token_type_ids", "labels": [B, C, T] (only the
    gold candidate carries reply labels; -100 = ignore), "mc_label": [B]
    (the gold candidate's index; -100 = a padded example)}. Every candidate
    runs through the transformer, flattened to [B*C, T]; the mc head scores
    each candidate at its last non-pad token (pad is only ever a tail). The
    LM term gathers the gold candidate's logits before the vocabulary
    softmax; the MC term is a softmax cross-entropy over the C candidates,
    added with weight ``mc_coef``. Per-token and per-example losses come
    from ``log_softmax`` and a gather (CUDA's ``nll_loss`` raises under
    deterministic mode). Metrics add ``mc_loss_sum``, ``mc_count`` and
    ``mc_correct`` to the LM sums."""

    def loss_fn(params: dict, net_state: dict, batch: dict, gen=None):
        ids = batch["input_ids"]
        B, C, T = ids.shape
        flat = ids.reshape(B * C, T)
        lengths = (flat != pad_id).sum(-1).clamp_min(1)
        lm_logits, mc_logits = functional_call(
            model, params, (flat,),
            {"train": train, "token_type_ids": batch["token_type_ids"].reshape(B * C, T),
             "gen": gen, "mc_positions": lengths - 1})
        mc_label = batch["mc_label"].long()
        gold = mc_label.clamp_min(0)  # padded examples read candidate 0, masked below
        V = lm_logits.shape[-1]
        lm_lgt = lm_logits.reshape(B, C, T, V).gather(
            1, gold.reshape(B, 1, 1, 1).expand(B, 1, T, V))[:, 0, :-1]
        labels = batch["labels"].long().gather(
            1, gold.reshape(B, 1, 1).expand(B, 1, T))[:, 0, 1:]
        mask = (labels != -100).to(lm_lgt.dtype)
        safe = labels.clamp_min(0)
        logp = F.log_softmax(lm_lgt, dim=-1)
        per_tok = -logp.gather(-1, safe[..., None])[..., 0]
        loss_sum = (per_tok * mask).sum()
        lm_loss = loss_sum / mask.sum().clamp_min(1.0)
        correct = ((lm_lgt.argmax(-1) == safe).to(mask.dtype) * mask).sum()

        scores = mc_logits.reshape(B, C)
        mc_mask = (mc_label >= 0).to(scores.dtype)
        per_ex = -F.log_softmax(scores, dim=-1).gather(1, gold[:, None])[:, 0]
        mc_loss_sum = (per_ex * mc_mask).sum()
        mc_loss = mc_loss_sum / mc_mask.sum().clamp_min(1.0)
        mc_correct = ((scores.argmax(-1) == gold).to(mc_mask.dtype) * mc_mask).sum()
        return lm_loss + mc_coef * mc_loss, {
            "net_state": net_state,
            "metrics": {"loss_sum": loss_sum, "count": mask.sum(), "correct": correct,
                        "mc_loss_sum": mc_loss_sum, "mc_count": mc_mask.sum(),
                        "mc_correct": mc_correct},
        }

    def dropout_masks(batch: dict, gen: torch.Generator) -> list:
        # every candidate runs through the transformer, flattened to [B*C, T]
        B, C, T = batch["input_ids"].shape
        return model.dropout_masks((B * C, T), gen) if train else []

    loss_fn.dropout_masks = dropout_masks
    return loss_fn
