"""The federated round step: the PyTorch twin of the JAX package's
``federated/engine.py`` for the single-device, ravel-path, linear-shortcut
round (mode=sketch and the uncompressed control).

One round, given the flat [d] params (ravel_pytree order, see
``models/convert.py``):

1. every sampled client runs one forward/backward on its own batch, with
   its own train-mode batch-norm statistics; weight decay is added
   client-side as ``gflat + wd * pflat``;
2. each client's update, batch-norm statistics and metrics are folded into
   participation-weighted running sums as soon as they exist, so one
   client's [d] gradient is live at a time; the sums are then normalised
   to the survivor mean;
3. sketching commutes with the mean, so the reduced update is compressed
   once (``modes.client_compress``) and lifted to the aggregate wire;
4. ``modes.server_step_sparse`` runs momentum and error feedback and
   releases the delta, which ``modes.apply_delta`` subtracts.

PyTorch runs eagerly, so the step is a plain function; nothing is
compiled. It makes new tensors and updates none in place, so a state once
returned is never written again (checkpoints read committed states while
later rounds run). State is a dict {"params": flat [d], "net_state": {buffer name:
tensor}, "mode_state": {"Vvelocity", "Verror"}, "round": int}.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.convert import FlatLayout
from ..modes import modes
from ..modes.config import ModeConfig

# reserved batch key: the [W] 0/1 validity mask of the sampled clients
VALID_KEY = "_valid"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The subset of the reference's EngineConfig this round reads."""

    mode: ModeConfig
    weight_decay: float = 0.0  # applied to the gradient client-side
    # "skip": a round whose aggregate or new batch-norm statistics are not
    # finite aggregates to zero and keeps the previous statistics (momentum
    # decays, state stays clean); "off" lets the poison through
    on_nonfinite: str = "off"

    def __post_init__(self):
        if self.on_nonfinite not in ("off", "skip"):
            raise ValueError(f"on_nonfinite must be 'off' or 'skip', got {self.on_nonfinite!r}")


def init_server_state(cfg: EngineConfig, pflat: torch.Tensor, net_state: dict) -> dict:
    return {
        "params": pflat,
        "net_state": net_state,
        "mode_state": modes.init_server_state(cfg.mode, pflat.device),
        "round": 0,
    }


def split_valid(batch: dict) -> tuple[dict, torch.Tensor | None]:
    """Pop the validity mask off a round batch (absent: all valid)."""
    if VALID_KEY in batch:
        batch = dict(batch)
        return batch, batch.pop(VALID_KEY)
    return batch, None


def _make_grad_client(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """One client's flat gradient (+ weight decay), new batch-norm
    statistics and metric sums."""

    def grad_client(params: dict, pflat: torch.Tensor, net_state: dict, cbatch: dict):
        loss, aux = loss_fn(params, net_state, cbatch)
        grads = torch.autograd.grad(loss, list(params.values()))
        gflat = layout.flatten(dict(zip(params, grads)))
        gflat = gflat + cfg.weight_decay * pflat
        detach = lambda tree: {k: v.detach() for k, v in tree.items()}  # noqa: E731
        return gflat, detach(aux["net_state"]), detach(aux["metrics"])

    return grad_client


def _weighted_client_reduce(grad_client: Callable, params: dict, pflat: torch.Tensor,
                            net_state: dict, batch: dict, part: torch.Tensor,
                            nan_safe: bool):
    """Participation-weighted SUMS over the sampled clients of updates,
    batch-norm statistics and metrics, folded client by client in cohort
    order: one client's [d] gradient is live at a time. nan_safe weights
    like ``modes.mask_rows``, so a masked client's NaN contributes an exact
    zero."""

    def weigh(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        w = w.to(x.dtype)
        return torch.where(w > 0, x * w, torch.zeros_like(x)) if nan_safe else x * w

    totals = None
    for w in range(part.shape[0]):
        outs = grad_client(params, pflat, net_state, {k: v[w] for k, v in batch.items()})
        # update, statistics, metrics, each as a dict
        parts = [{k: weigh(part[w], x) for k, x in t.items()}
                 for t in ({"u": outs[0]}, outs[1], outs[2])]
        totals = parts if totals is None else [{k: a[k] + b[k] for k in a}
                                               for a, b in zip(totals, parts)]
        del outs, parts  # free this client's gradient before the next one's
    return totals[0]["u"], totals[1], totals[2]


def reduce_clients(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout,
                   state: dict, batch: dict) -> tuple[torch.Tensor, dict, dict]:
    """The client phase of a round: (reduced update [d], survivor-mean
    batch-norm statistics, metric sums with the participants count)."""
    batch, valid = split_valid(batch)
    pflat, net_state = state["params"], state["net_state"]
    part = (valid.to(torch.float32) if valid is not None
            else torch.ones(batch["x"].shape[0], dtype=torch.float32, device=pflat.device))
    params = {k: v.requires_grad_(True) for k, v in layout.unflatten(pflat).items()}
    wsum, ns_sum, m_sum = _weighted_client_reduce(
        _make_grad_client(loss_fn, cfg, layout), params, pflat, net_state,
        batch, part, nan_safe=valid is not None)
    # survivor mean (or sum), previous statistics when nobody survived
    n_live = part.sum().clamp_min(1.0)
    weighted = wsum if cfg.mode.agg_op == "sum" else wsum / n_live
    alive = part.sum() > 0
    new_net_state = {k: torch.where(alive, s / n_live, net_state[k]) for k, s in ns_sum.items()}
    metrics = dict(m_sum)
    metrics["participants"] = part.sum()
    return weighted, new_net_state, metrics


def _all_finite(tensors) -> torch.Tensor:
    ok = None
    for t in tensors:
        if t.is_floating_point():
            f = torch.isfinite(t).all()
            ok = f if ok is None else ok & f
    return ok


def _guard_nonfinite(cfg: EngineConfig, agg: dict, new_net_state: dict,
                     net_state: dict, metrics: dict):
    """on_nonfinite="skip": zero a non-finite aggregate, keep the previous
    batch-norm statistics, zero the round's training sums and flag it in
    ``nonfinite_rounds``. On finite data every select keeps its input."""
    if cfg.on_nonfinite != "skip":
        return agg, new_net_state, metrics
    ok = _all_finite([*agg.values(), *new_net_state.values()])
    agg = {k: torch.where(ok, v, torch.zeros_like(v)) if v.is_floating_point() else v
           for k, v in agg.items()}
    new_net_state = {k: torch.where(ok, v, net_state[k]) for k, v in new_net_state.items()}
    metrics = {k: v if k == "participants" else torch.where(ok, v, torch.zeros_like(v))
               for k, v in metrics.items()}
    metrics["nonfinite_rounds"] = (~ok).to(torch.float32)
    return agg, new_net_state, metrics


def make_round_step(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """step(state, batch, lr) -> (state', metrics). ``batch`` holds tensors
    with leading axis W (the sampled clients), optionally with the
    ``VALID_KEY`` mask; ``lr`` is the round's learning rate, a float32 0-d
    tensor on the state's device (the session copies it there without a
    host sync) or a Python float; metrics are device tensors summed over
    clients."""
    mcfg = cfg.mode

    def step(state: dict, batch: dict, lr: float):
        weighted, new_net_state, metrics = reduce_clients(loss_fn, cfg, layout, state, batch)
        # linearity shortcut: compress the reduced update once
        wire, _ = modes.client_compress(mcfg, weighted, {})
        agg = modes.aggregate(mcfg, {k: v[None] for k, v in wire.items()})
        agg, new_net_state, metrics = _guard_nonfinite(
            cfg, agg, new_net_state, state["net_state"], metrics)
        pflat = state["params"]
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32,
                                                           device=pflat.device)
        delta, mode_state = modes.server_step_sparse(mcfg, agg, state["mode_state"], lr_t)
        new_state = {
            "params": modes.apply_delta(pflat, delta),
            "net_state": new_net_state,
            "mode_state": mode_state,
            "round": state["round"] + 1,
        }
        return new_state, metrics

    return step


def make_multi_round_step(loss_fn: Callable, cfg: EngineConfig,
                          layout: FlatLayout) -> Callable:
    """K rounds in one call, the twin of the reference's
    ``make_multi_round_step``: multi(state, batches, lrs) -> (state',
    metrics) with every batch leaf [K, W, ...], ``lrs`` a float32 [K]
    tensor and every metric stacked to [K]. The reference scans the round
    step in one compiled program; eager PyTorch has no scan, so this is a
    loop over the same step, which keeps it bitwise equal to K single
    rounds. Both ported modes are stateless per client, so any block of
    rounds can run this way."""
    step = make_round_step(loss_fn, cfg, layout)

    def multi(state: dict, batches: dict, lrs: torch.Tensor):
        per_round = []
        for i in range(lrs.shape[0]):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()}, lrs[i])
            per_round.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_round]) for k in per_round[0]}

    return multi


def make_eval_step(loss_fn: Callable, layout: FlatLayout) -> Callable:
    """eval(params_flat, net_state, batch) -> metric sums, forward only."""

    def evaluate(pflat: torch.Tensor, net_state: dict, batch: dict) -> dict:
        with torch.no_grad():
            _, aux = loss_fn(layout.unflatten(pflat), net_state, batch)
        return aux["metrics"]

    return evaluate
