"""The federated round step: the PyTorch twin of the JAX package's
``federated/engine.py`` for the single-device ravel-path round, in every
mode: FetchSGD's sketch, true_topk, local_topk, fedavg/localSGD and the
uncompressed control.

One round, given the flat [d] params (ravel_pytree order, see
``models/convert.py``):

1. every sampled client computes its update from its own batch, with its
   own train-mode batch-norm statistics: one forward/backward with weight
   decay added client-side (``gflat + wd * pflat``), or for
   fedavg/localSGD ``num_local_iters`` local SGD steps whose weight delta
   ``p0 - p_final`` is the update; local_topk then compresses each
   client's update with that client's rows of the client state;
2. each client's update, batch-norm statistics and metrics are folded into
   participation-weighted running sums as soon as they exist, so one
   client's [d] update is live at a time; the sums are then normalised to
   the survivor mean. The reference vmaps the clients and reduces them in
   one XLA sum: with more than two clients the two packages add in another
   order (float32 rounding, about 1e-7 relative);
3. every mode but local_topk is linear and takes the shortcut:
   compressing commutes with the mean, so the reduced update is compressed
   once (``modes.client_compress``) and lifted to the aggregate wire;
4. ``modes.server_step_sparse`` runs momentum and error feedback and
   releases the delta, which ``modes.apply_delta`` subtracts.

PyTorch runs eagerly, so the step is a plain function; nothing is
compiled. It makes new tensors and updates none in place, so a state once
returned is never written again (checkpoints read committed states while
later rounds run). State is a dict {"params": flat [d], "net_state": {buffer
name: tensor}, "mode_state": {"Vvelocity", "Verror"}, "round": int}; client
rows are {key: [W, d]} slices of the session's client state ({} when the
mode keeps none).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.convert import FlatLayout
from ..modes import modes
from ..modes.config import ModeConfig
from ..sketch import csvec

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


def _detach(tree: dict) -> dict:
    return {k: v.detach() for k, v in tree.items()}


def _flat_grad(loss_fn: Callable, layout: FlatLayout, pflat: torch.Tensor,
               net_state: dict, cbatch: dict, params: dict | None = None):
    """(flat gradient, loss aux) of one batch at the flat params ``pflat``.
    ``params`` may pass ``pflat``'s unflattened leaves, already requiring
    grad, so that a cohort shares them."""
    if params is None:
        params = {k: v.requires_grad_(True) for k, v in layout.unflatten(pflat).items()}
    loss, aux = loss_fn(params, net_state, cbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return layout.flatten(dict(zip(params, grads))), aux


def make_client_update(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """update(state, cbatch, lr, params=None) -> (flat [d] update, new
    batch-norm statistics, metric sums) of one client, before compression:
    its gradient plus weight decay, or for fedavg/localSGD the weight delta
    ``p0 - p_final`` of ``num_local_iters`` local SGD steps at ``lr`` over
    the microbatches ``cbatch[key][i]``, with weight decay inside the loop,
    local momentum only for momentum_type="local", the batch-norm
    statistics carried from step to step and the metrics summed over the
    steps."""
    mcfg = cfg.mode
    wd = cfg.weight_decay

    def grad_update(state, cbatch, lr, params=None):
        pflat = state["params"]
        gflat, aux = _flat_grad(loss_fn, layout, pflat, state["net_state"], cbatch, params)
        return gflat + wd * pflat, _detach(aux["net_state"]), _detach(aux["metrics"])

    def local_sgd_update(state, cbatch, lr, params=None):
        mu = mcfg.momentum if mcfg.momentum_type == "local" else 0.0
        p0 = state["params"]
        p_cur, nstate, mom, msum = p0, state["net_state"], torch.zeros_like(p0), None
        for i in range(mcfg.num_local_iters):
            micro = {k: v[i] for k, v in cbatch.items()}
            gflat, aux = _flat_grad(loss_fn, layout, p_cur, nstate, micro)
            mom = mu * mom + (gflat + wd * p_cur)
            p_cur = p_cur - lr * mom
            nstate = _detach(aux["net_state"])
            m = _detach(aux["metrics"])
            msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
        return p0 - p_cur, nstate, msum

    return local_sgd_update if mcfg.uses_weight_delta else grad_update


def _weighted_client_fold(client_fn: Callable, batch: dict, part: torch.Tensor):
    """Participation-weighted SUMS over the sampled clients of the update,
    statistics and metrics that ``client_fn(w, cbatch) -> (update,
    statistics, metrics, row)`` returns, folded client by client in cohort
    order: one client's [d] update is live at a time. Also returns the list
    of rows. Weighs like ``modes.mask_rows``, so a masked client's NaN
    contributes an exact zero."""

    def weigh(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        w = w.to(x.dtype)
        return torch.where(w > 0, x * w, torch.zeros_like(x))

    totals, rows = None, []
    for w in range(part.shape[0]):
        update, stats, metrics, row = client_fn(w, {k: v[w] for k, v in batch.items()})
        rows.append(row)
        # update, statistics, metrics, each as a dict
        parts = [{k: weigh(part[w], x) for k, x in t.items()}
                 for t in ({"u": update}, stats, metrics)]
        totals = parts if totals is None else [{k: a[k] + b[k] for k in a}
                                               for a, b in zip(totals, parts)]
        del update, parts  # free this client's update before the next one's
    return totals[0]["u"], totals[1], totals[2], rows


def _client_phase(update: Callable, mcfg: ModeConfig, layout: FlatLayout, state: dict,
                  batch: dict, client_rows: dict, lr):
    """The client phase of a round: each client's update (local_topk: its
    densified top-k wire, compressed with its rows of the client state)
    folded into participation-weighted sums. Returns the reduced update [d]
    (the survivor mean unless agg_op=sum), the survivor mean of the
    batch-norm statistics (the previous ones when nobody survived), the
    metric sums with the participants count and the cohort's new rows ([W,
    d] per key; a client that did not take part keeps its row)."""
    pflat = state["params"]
    batch, valid = split_valid(batch)
    part = (valid.to(torch.float32) if valid is not None
            else torch.ones(batch["x"].shape[0], dtype=torch.float32, device=pflat.device))
    # the grad modes' clients share one set of leaves requiring grad
    params = (None if mcfg.uses_weight_delta else
              {k: v.requires_grad_(True) for k, v in layout.unflatten(pflat).items()})

    def client(w: int, cb: dict):
        u, stats, metrics = update(state, cb, lr, params)
        if modes.is_linear(mcfg):
            return u, stats, metrics, {}
        row = {k: v[w] for k, v in client_rows.items()}
        wire, new_row = modes.client_compress(mcfg, u, row)
        new_row = {k: torch.where(part[w] > 0, v, row[k]) for k, v in new_row.items()}
        return csvec.to_dense(mcfg.d, wire["idx"], wire["vals"]), stats, metrics, new_row

    wsum, ns_sum, m_sum, rows = _weighted_client_fold(client, batch, part)
    n_live = part.sum().clamp_min(1.0)
    weighted = wsum if mcfg.agg_op == "sum" else wsum / n_live
    alive = part.sum() > 0
    new_net_state = {k: torch.where(alive, v / n_live, state["net_state"][k])
                     for k, v in ns_sum.items()}
    metrics = dict(m_sum)
    metrics["participants"] = part.sum()
    new_rows = {k: torch.stack([r[k] for r in rows]) for k in client_rows}
    return weighted, new_net_state, metrics, new_rows


def reduce_clients(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout,
                   state: dict, batch: dict) -> tuple[torch.Tensor, dict, dict]:
    """The client phase of a round of a mode without client state: (reduced
    update [d], survivor-mean batch-norm statistics, metric sums with the
    participants count)."""
    weighted, new_net_state, metrics, _ = _client_phase(
        make_client_update(loss_fn, cfg, layout), cfg.mode, layout, state, batch, {}, None)
    return weighted, new_net_state, metrics


def _all_finite(tensors) -> torch.Tensor:
    ok = None
    for t in tensors:
        if t.is_floating_point():
            f = torch.isfinite(t).all()
            ok = f if ok is None else ok & f
    return ok


def _guard_nonfinite(cfg: EngineConfig, agg: dict, new_net_state: dict, net_state: dict,
                     new_rows: dict, client_rows: dict, metrics: dict):
    """on_nonfinite="skip": zero a non-finite aggregate, keep the previous
    batch-norm statistics and client rows, zero the round's training sums
    and flag it in ``nonfinite_rounds``. On finite data every select keeps
    its input."""
    if cfg.on_nonfinite != "skip":
        return agg, new_net_state, new_rows, metrics
    ok = _all_finite([*agg.values(), *new_net_state.values(), *new_rows.values()])
    agg = {k: torch.where(ok, v, torch.zeros_like(v)) if v.is_floating_point() else v
           for k, v in agg.items()}
    new_net_state = {k: torch.where(ok, v, net_state[k]) for k, v in new_net_state.items()}
    new_rows = {k: torch.where(ok, v, client_rows[k]) for k, v in new_rows.items()}
    metrics = {k: v if k == "participants" else torch.where(ok, v, torch.zeros_like(v))
               for k, v in metrics.items()}
    metrics["nonfinite_rounds"] = (~ok).to(torch.float32)
    return agg, new_net_state, new_rows, metrics


def make_round_step(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """step(state, batch, client_rows, lr) -> (state', client_rows',
    metrics): the reference's step without its device RNG. ``batch`` holds
    tensors with leading axis W (the sampled clients; fedavg/localSGD add a
    [num_local_iters] axis after it), optionally with the ``VALID_KEY``
    mask; ``client_rows`` is {key: [W, d]} of the cohort's client state ({}
    when the mode keeps none); ``lr`` is the round's learning rate, a
    float32 0-d tensor on the state's device (the session copies it there
    without a host sync) or a Python float. The grad modes apply it at the
    server; the weight-delta modes take it in the local steps and apply the
    averaged delta at ``server_lr``. Metrics are device tensors summed over
    clients (and local steps)."""
    mcfg = cfg.mode
    update = make_client_update(loss_fn, cfg, layout)

    def step(state: dict, batch: dict, client_rows: dict, lr):
        pflat = state["params"]
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32,
                                                           device=pflat.device)
        weighted, new_net_state, metrics, new_rows = _client_phase(
            update, mcfg, layout, state, batch, client_rows, lr_t)
        if modes.is_linear(mcfg):
            # linearity shortcut: compress the reduced update once
            wire, _ = modes.client_compress(mcfg, weighted, {})
            agg = modes.aggregate(mcfg, {k: v[None] for k, v in wire.items()})
        else:
            agg = {"dense": weighted}
        agg, new_net_state, new_rows, metrics = _guard_nonfinite(
            cfg, agg, new_net_state, state["net_state"], new_rows, client_rows, metrics)
        # the weight-delta modes' local steps consumed lr; the server applies
        # the averaged delta at server_lr
        server_lr = mcfg.server_lr if mcfg.uses_weight_delta else lr_t
        delta, mode_state = modes.server_step_sparse(mcfg, agg, state["mode_state"], server_lr)
        if mcfg.mode == "local_topk":
            # the broadcast delta's support: local_topk's measured down-link
            metrics["down_support"] = modes.delta_support(mcfg.d, delta)
        new_state = {
            "params": modes.apply_delta(pflat, delta),
            "net_state": new_net_state,
            "mode_state": mode_state,
            "round": state["round"] + 1,
        }
        return new_state, new_rows, metrics

    return step


def make_multi_round_step(loss_fn: Callable, cfg: EngineConfig,
                          layout: FlatLayout) -> Callable:
    """K rounds in one call, the twin of the reference's
    ``make_multi_round_step``: multi(state, batches, lrs) -> (state',
    metrics) with every batch leaf [K, W, ...], ``lrs`` a float32 [K]
    tensor and every metric stacked to [K]. The reference scans the round
    step in one compiled program; eager PyTorch has no scan, so this is a
    loop over the same step, which keeps it bitwise equal to K single
    rounds. A mode with per-client state is refused, as in the reference:
    the session gathers and scatters its rows between rounds."""
    if cfg.mode.needs_local_state:
        raise ValueError(
            "multi-round dispatch requires a mode without per-client persistent state "
            "(the session gathers/scatters those rows between rounds); use per-round "
            f"dispatch for mode={cfg.mode.mode!r} error_type={cfg.mode.error_type!r}")
    step = make_round_step(loss_fn, cfg, layout)

    def multi(state: dict, batches: dict, lrs: torch.Tensor):
        per_round = []
        for i in range(lrs.shape[0]):
            state, _, metrics = step(state, {k: v[i] for k, v in batches.items()}, {}, lrs[i])
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
