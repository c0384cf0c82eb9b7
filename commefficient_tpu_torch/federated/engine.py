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
2. the clients' updates come from one ``torch.func.vmap`` of one
   client's pure update (``make_client_updates``) over the stacked
   cohort, as the reference's ``jax.vmap``; their updates, batch-norm
   statistics and metrics are reduced to participation-weighted sums over
   the client axis (``modes.mask_rows``, then ``.sum(0)``) and normalised
   to the survivor mean. With ``client_chunk`` C > 0 the linear grad modes
   run W / C vmapped chunks whose sums are added in chunk order, so at most
   C full [d] updates are live at a time;
3. every mode but local_topk is linear and takes the shortcut:
   compressing commutes with the mean, so the reduced update is compressed
   once (``modes.client_compress``) and lifted to the aggregate wire;
4. ``modes.server_step_sparse`` runs momentum and error feedback and
   releases the delta, which ``modes.apply_delta`` subtracts.

The wire-payload round (``wire_payloads``, ``make_payload_round_steps``)
has no shortcut: every client's update is sketched into its own table,
and the server merges the tables by an ordered sum.

Client participation: a client takes part in a round when the batch's
validity mask (``VALID_KEY``: a dropped client, a failed data load) says
so and it survives ``client_dropout``. Every sum, normalisation,
batch-norm merge and client-row select reads that one [W] weight, so a
client that does not take part adds exact zeros, and a round where nobody
does aggregates zero (momentum still decays) and keeps its batch-norm
statistics and client rows. With ``dp_clip`` each client's update is
clipped to that L2 norm before the sum; with ``dp_noise`` the aggregate
gets central Gaussian noise scaled to the survivors (none when nobody
took part).

Randomness: a training forward that draws (GPT-2's dropout) reads keep
masks drawn from a ``torch.Generator`` per (round, client slot, local
step), seeded by ``dropout_seed`` from the engine's seed and those three
indices. Nothing draws under the vmap: the loss's ``dropout_masks(cbatch,
gen)`` draws each client's masks before it, in the forward's order and at
its shapes, and the stacked masks enter the map as the loss's fourth
argument, a batched input. The participation mask and the DP noise come from
generators seeded the same way under tags of their own
(``PARTICIPATION_TAG``, ``NOISE_TAG``), so no stream collides with
another. Every seed is a pure function of the round, so the async and sync
loops, and a run resumed from a checkpoint, draw the same values with no
generator state to carry. The classification losses draw nothing.
The reference draws its mask and noise from JAX's threefry keys, which
torch cannot reproduce: parity with it is distributional.

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

from ..data.fed_dataset import splitmix64
from ..models.convert import FlatLayout
from ..modes import modes
from ..modes.config import ModeConfig
from ..sketch import csvec

# reserved batch key: the [W] 0/1 validity mask of the sampled clients
VALID_KEY = "_valid"
# the client-slot words of the participation mask's and the DP noise's
# seeds: far above any cohort position, so neither stream meets a
# client's dropout stream
PARTICIPATION_TAG = 0x5041525449434950
NOISE_TAG = 0x44504E4F495345


def dropout_seed(seed: int, rnd: int, slot: int, step: int) -> int:
    """The seed of the generator a client's training forward draws from:
    splitmix64 folded over (seed, round, client slot, local step), below
    2**63 (what ``torch.Generator.manual_seed`` takes)."""
    x = 0
    for word in (seed, rnd, slot, step):
        x = splitmix64(x ^ (word & ((1 << 64) - 1)))
    return x >> 1


def participation_mask(seed: int, rnd: int, num_sampled: int, dropout: float,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """[W] float32 0/1 survivor mask of round ``rnd``: each sampled client
    independently drops with probability ``dropout``. A pure function of
    (seed, round, W, dropout): drawn on the host from a CPU generator
    seeded ``dropout_seed(seed, rnd, PARTICIPATION_TAG, 0)``, so the CPU and
    the card get the same mask, and copied to a GPU from pinned memory
    without a host sync."""
    if dropout <= 0.0:
        return torch.ones(num_sampled, dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(dropout_seed(seed, rnd, PARTICIPATION_TAG, 0))
    mask = (torch.rand(num_sampled, generator=gen) >= dropout).to(torch.float32)
    if torch.device(device).type == "cuda":
        return mask.pin_memory().to(device, non_blocking=True)
    return mask


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The subset of the reference's EngineConfig this round reads."""

    mode: ModeConfig
    weight_decay: float = 0.0  # applied to the gradient client-side
    # "skip": a round whose aggregate or new batch-norm statistics are not
    # finite aggregates to zero and keeps the previous statistics (momentum
    # decays, state stays clean); "off" lets the poison through
    on_nonfinite: str = "off"
    # the run's seed, from which every training forward's generator, the
    # participation mask and the DP noise are derived (dropout_seed)
    seed: int = 0
    # each sampled client independently drops before aggregation with this
    # probability (participation_mask)
    client_dropout: float = 0.0
    # differential privacy: dp_clip > 0 clips each client's update to that
    # L2 norm before the sum; dp_noise > 0 adds N(0, (dp_noise * sens)^2)
    # to every aggregate entry, sens = dp_clip for agg_op="sum" and
    # dp_clip / participants for the mean
    dp_clip: float = 0.0
    dp_noise: float = 0.0
    # the wire-payload round (--serve_payload sketch): every client sketches
    # its own update and the server merges the per-client tables
    # (make_payload_round_steps) instead of compressing the reduced update
    wire_payloads: bool = False
    # > 0: the linear grad modes vmap the clients in W / client_chunk chunks
    # of this many, adding the chunks' sums in chunk order, so at most this
    # many full [d] updates are live at a time (must divide W); 0: one vmap
    # of all W. fedavg/localSGD, local_topk and the payload round ignore it
    client_chunk: int = 0

    def generator(self, rnd: int, slot: int, step: int,
                  device: torch.device) -> torch.Generator:
        """The generator of client slot ``slot``'s local step ``step`` in
        round ``rnd``, on ``device``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(self.seed, rnd, slot, step))
        return gen

    def __post_init__(self):
        if self.on_nonfinite not in ("off", "skip"):
            raise ValueError(f"on_nonfinite must be 'off' or 'skip', got {self.on_nonfinite!r}")
        if self.client_chunk < 0:
            raise ValueError(f"client_chunk must be >= 0, got {self.client_chunk}")
        if not 0.0 <= self.client_dropout < 1.0:
            raise ValueError(f"client_dropout must be in [0, 1), got {self.client_dropout}")
        if self.dp_clip < 0 or self.dp_noise < 0:
            raise ValueError(f"dp_clip and dp_noise must be >= 0, got {self.dp_clip} and "
                             f"{self.dp_noise}")
        if self.wire_payloads and self.mode.mode != "sketch":
            raise ValueError(f"wire_payloads needs mode='sketch' (per-client Count-Sketch "
                             f"tables); mode={self.mode.mode!r} has no table wire")
        if self.dp_noise > 0 and self.dp_clip <= 0:
            raise ValueError("dp_noise > 0 requires dp_clip > 0 (unbounded sensitivity has no "
                             "meaningful noise scale)")
        if self.dp_noise > 0 and self.mode.needs_local_state:
            raise ValueError(
                "dp_noise with client-local error/momentum state is unsound: the transmitted "
                "wire is topk(error_accumulator + update), whose norm is unbounded across "
                "rounds, so dp_clip does not bound sensitivity. Use local_topk with "
                "error_type=none and momentum_type=none/virtual, or a mode without "
                "client-local state.")
        if self.dp_noise > 0 and self.mode.mode == "sketch":
            raise ValueError(
                "dp_noise with mode=sketch is unsound: a count-sketch table's worst-case L2 "
                "sensitivity under an L2 clip is l1-scale, so dp_clip-calibrated Gaussian "
                "noise on the table under-delivers the configured privacy. Use a dense-wire "
                "mode (uncompressed/true_topk/fedavg/localSGD) or local_topk without local "
                "state.")


def init_server_state(cfg: EngineConfig, pflat: torch.Tensor, net_state: dict) -> dict:
    if cfg.dp_noise > 0 and net_state:
        raise ValueError(
            "dp_noise with mutable model collections (e.g. BatchNorm batch_stats) is unsound: "
            "per-client statistics are averaged into the released model without clipping or "
            "noise, bypassing the DP mechanism. Use a normalization-free model for DP runs.")
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


def _draw_masks(loss_fn: Callable, cfg: EngineConfig, rnd: int, slots: range, step: int,
                cbatch: dict, device: torch.device) -> list | None:
    """The dropout keep masks of the clients in cohort slots ``slots`` at
    local step ``step``, drawn outside the map from each slot's generator
    ``cfg.generator(rnd, slot, step)`` by the loss's ``dropout_masks``, in
    the forward's order and at its shapes, then stacked on a leading client
    axis: what the loop of one generator per client drew, bitwise. None when
    the loss draws nothing (no ``dropout_masks``, or dropout off)."""
    draw = getattr(loss_fn, "dropout_masks", None)
    if draw is None:
        return None
    per_client = [draw({k: v[i] for k, v in cbatch.items()},
                       cfg.generator(rnd, slot, step, device))
                  for i, slot in enumerate(slots)]
    if not per_client[0]:
        return None
    return [torch.stack(site) for site in zip(*per_client)]


def make_client_updates(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """updates(state, cbatch, lr, slots) -> ([C, d] updates, new batch-norm
    statistics {k: [C, ...]}, metric sums {k: [C]}) of the C clients in
    cohort slots ``slots``, whose batches are stacked on the leading axis of
    ``cbatch``, before clipping and compression: one ``torch.func.vmap`` of
    one client's pure update over the C clients.

    A client's update is its gradient (``torch.func.grad`` of the loss over
    the unflattened leaves, flattened) plus weight decay, or for
    fedavg/localSGD the weight delta ``p0 - p_final`` of ``num_local_iters``
    local SGD steps at ``lr`` over the microbatches ``cbatch[key][:, i]``,
    with weight decay inside the loop, local momentum only for
    momentum_type="local", the batch-norm statistics carried from step to
    step and the metrics summed over the steps. Each forward reads the
    dropout masks of ``cfg.generator(state["round"], slot, step)``, drawn
    before the map (``_draw_masks``). Batch norm computes each client's
    statistics over that client's own batch under the map."""
    mcfg = cfg.mode
    wd = cfg.weight_decay

    def grad_one(pflat, net_state, cbatch, masks):
        def loss(leaves):
            return loss_fn(leaves, net_state, cbatch, masks)

        grads, aux = torch.func.grad(loss, has_aux=True)(layout.unflatten(pflat))
        return layout.flatten(grads) + wd * pflat, aux["net_state"], aux["metrics"]

    def local_sgd_one(pflat, net_state, cbatch, masks, lr):
        mu = mcfg.momentum if mcfg.momentum_type == "local" else 0.0
        p_cur, nstate, mom, msum = pflat, net_state, torch.zeros_like(pflat), None
        for i in range(mcfg.num_local_iters):
            micro = {k: v[i] for k, v in cbatch.items()}
            g, nstate, m = grad_one(p_cur, nstate, micro, None if masks is None else masks[i])
            mom = mu * mom + g
            p_cur = p_cur - lr * mom
            msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
        return pflat - p_cur, nstate, msum

    def updates(state, cbatch, lr, slots):
        pflat = state["params"]
        rnd = state["round"]
        if mcfg.uses_weight_delta:
            masks = [_draw_masks(loss_fn, cfg, rnd, slots, i,
                                 {k: v[:, i] for k, v in cbatch.items()}, pflat.device)
                     for i in range(mcfg.num_local_iters)]
            masks = None if masks[0] is None else masks
            # vmap's default randomness="error": nothing may draw under the map
            return torch.func.vmap(
                local_sgd_one, in_dims=(None, None, 0, None if masks is None else 0, None))(
                pflat, state["net_state"], cbatch, masks, lr)
        masks = _draw_masks(loss_fn, cfg, rnd, slots, 0, cbatch, pflat.device)
        return torch.func.vmap(grad_one, in_dims=(None, None, 0, None if masks is None else 0))(
            pflat, state["net_state"], cbatch, masks)

    return updates


def clip_factor(u: torch.Tensor, clip: float) -> torch.Tensor:
    """The DP clip's factor of each client's update, along the last axis
    (one client's [d] update, or a [W, d] stack: one factor per row):
    min(1, clip / max(||u||, 1e-12)), the L2 norm in float32."""
    nrm = torch.linalg.vector_norm(u.to(torch.float32), dim=-1)
    return torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)


def _clip_rows(cfg: EngineConfig, updates: torch.Tensor,
               part: torch.Tensor | None = None) -> torch.Tensor:
    """The [W, d] updates, each row clipped to ``dp_clip`` in L2 (unchanged
    when the clip is off): nonlinear, so it comes before any sum. With
    ``part``, a client that does not take part keeps factor 1: its row (NaN
    behind a mask, say) is weighed to an exact zero afterwards."""
    if cfg.dp_clip <= 0:
        return updates
    fac = clip_factor(updates, cfg.dp_clip)
    if part is not None:
        fac = torch.where(part > 0, fac, torch.ones_like(fac))
    return updates * fac[:, None]


def _weighted_sums(part: torch.Tensor, updates: torch.Tensor, stats: dict,
                   metrics: dict) -> tuple[torch.Tensor, dict, dict]:
    """Participation-weighted sums over the client axis of the stacked
    updates, statistics and metrics (``modes.mask_rows``, then ``.sum(0)``):
    a masked client's NaN contributes an exact zero."""
    return (modes.mask_rows(part, updates).sum(0),
            {k: modes.mask_rows(part, v).sum(0) for k, v in stats.items()},
            {k: modes.mask_rows(part, v).sum(0) for k, v in metrics.items()})


def _compress_rows(mcfg: ModeConfig, updates: torch.Tensor, part: torch.Tensor,
                   client_rows: dict) -> tuple[torch.Tensor, dict]:
    """local_topk: each client's update compressed with its rows of the
    client state (``modes.client_compress``), row by row in cohort order.
    Returns the densified wires [W, d] and the new rows (a client that does
    not take part keeps its rows)."""
    dense, rows = [], []
    for w in range(updates.shape[0]):
        wire, row = modes.client_compress(mcfg, updates[w],
                                          {k: v[w] for k, v in client_rows.items()})
        dense.append(csvec.to_dense(mcfg.d, wire["idx"], wire["vals"]))
        rows.append(row)
    new_rows = {k: torch.where(modes.bcast(part, v) > 0, torch.stack([r[k] for r in rows]), v)
                for k, v in client_rows.items()}
    return torch.stack(dense), new_rows


def _cohort_part(cfg: EngineConfig, state: dict, batch: dict):
    """(batch without the validity mask, W, the [W] participation weight):
    the validity mask times the round's ``participation_mask``."""
    batch, valid = split_valid(batch)
    # W: the leading dimension every leaf shares (an LM batch has no "x")
    n_clients = next(iter(batch.values())).shape[0]
    part = participation_mask(cfg.seed, state["round"], n_clients, cfg.client_dropout,
                              state["params"].device)
    if valid is not None:
        part = part * valid.to(torch.float32)
    return batch, n_clients, part


def _client_phase(updates: Callable, cfg: EngineConfig, state: dict, batch: dict,
                  client_rows: dict, lr):
    """The client phase of a round: the clients' updates (clipped to
    ``dp_clip``; local_topk: then their densified top-k wires, compressed
    with their rows of the client state) reduced to participation-weighted
    sums over the stacked client axis, as the reference's
    ``_weighted_client_reduce`` does. The participation weight is the
    batch's validity mask times the round's ``participation_mask``.

    The linear grad modes run one vmap over all W clients at
    ``client_chunk`` 0, else W / C vmapped chunks of C clients whose sums
    are added in chunk order, so at most C full [d] updates are live at a
    time. fedavg/localSGD and local_topk run one vmap of all W (the knob is
    ignored, as in the reference); local_topk then compresses row by row in
    cohort order. Returns the reduced update [d] (the survivor mean unless
    agg_op=sum), the survivor mean of the batch-norm statistics (the
    previous ones when nobody survived), the metric sums with the
    participants count and the cohort's new rows ([W, d] per key; a client
    that did not take part keeps its row)."""
    mcfg = cfg.mode
    batch, W, part = _cohort_part(cfg, state, batch)
    C = cfg.client_chunk
    if mcfg.uses_weight_delta or not modes.is_linear(mcfg) or not C or C >= W:
        C = W
    if W % C:
        raise ValueError(f"client_chunk={C} must divide the sampled cohort ({W})")
    sums, new_rows = None, {}
    for lo in range(0, W, C):
        cb = {k: v[lo:lo + C] for k, v in batch.items()}
        cpart = part[lo:lo + C]
        u, stats, metrics = updates(state, cb, lr, range(lo, lo + C))
        u = _clip_rows(cfg, u, cpart)
        if not modes.is_linear(mcfg):
            u, new_rows = _compress_rows(mcfg, u, part, client_rows)
        chunk = _weighted_sums(cpart, u, stats, metrics)
        del u  # this chunk's updates are gone before the next chunk's exist
        sums = chunk if sums is None else (
            sums[0] + chunk[0], {k: v + chunk[1][k] for k, v in sums[1].items()},
            {k: v + chunk[2][k] for k, v in sums[2].items()})
    wsum, ns_sum, m_sum = sums
    n_live = part.sum().clamp_min(1.0)
    weighted = wsum if mcfg.agg_op == "sum" else wsum / n_live
    new_net_state, metrics = _merged_survivor_finalize(ns_sum, m_sum, part, state["net_state"])
    return weighted, new_net_state, metrics, new_rows


def reduce_clients(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout,
                   state: dict, batch: dict) -> tuple[torch.Tensor, dict, dict]:
    """The client phase of a round of a mode without client state: (reduced
    update [d], survivor-mean batch-norm statistics, metric sums with the
    participants count)."""
    weighted, new_net_state, metrics, _ = _client_phase(
        make_client_updates(loss_fn, cfg, layout), cfg, state, batch, {}, None)
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
    its input. Also returns the round's finite flag (None with "off")."""
    if cfg.on_nonfinite != "skip":
        return agg, new_net_state, new_rows, metrics, None
    ok = _all_finite([*agg.values(), *new_net_state.values(), *new_rows.values()])
    agg = {k: torch.where(ok, v, torch.zeros_like(v)) if v.is_floating_point() else v
           for k, v in agg.items()}
    new_net_state = {k: torch.where(ok, v, net_state[k]) for k, v in new_net_state.items()}
    new_rows = {k: torch.where(ok, v, client_rows[k]) for k, v in new_rows.items()}
    metrics = {k: v if k == "participants" else torch.where(ok, v, torch.zeros_like(v))
               for k, v in metrics.items()}
    metrics["nonfinite_rounds"] = (~ok).to(torch.float32)
    return agg, new_net_state, new_rows, metrics, ok


def _dp_noise_agg(cfg: EngineConfig, agg: dict, participants: torch.Tensor, rnd: int) -> dict:
    """Central DP on the aggregate: N(0, std^2) on every entry, std =
    dp_noise * sens * (participants > 0), sens = dp_clip for agg_op="sum"
    and dp_clip / max(participants, 1) for the mean (the mean divides by
    the survivors, so its sensitivity does too). An empty round transmits
    nothing and releases nothing. One generator per aggregate key, in
    sorted key order, seeded ``dropout_seed(seed, rnd, NOISE_TAG, i)`` on
    the aggregate's device."""
    n_live = participants.clamp_min(1.0)
    sens = cfg.dp_clip if cfg.mode.agg_op == "sum" else cfg.dp_clip / n_live
    std = cfg.dp_noise * sens * (participants > 0).to(torch.float32)
    out = {}
    for i, (k, v) in enumerate(sorted(agg.items())):
        gen = torch.Generator(device=v.device)
        gen.manual_seed(dropout_seed(cfg.seed, rnd, NOISE_TAG, i))
        out[k] = v + std * torch.randn(v.shape, generator=gen, device=v.device, dtype=v.dtype)
    return out


def make_round_step(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """step(state, batch, client_rows, lr) -> (state', client_rows',
    metrics): the reference's step, its device RNG replaced by generators
    seeded from (cfg.seed, state["round"]). ``batch`` holds
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
    updates = make_client_updates(loss_fn, cfg, layout)

    def step(state: dict, batch: dict, client_rows: dict, lr):
        pflat = state["params"]
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32,
                                                           device=pflat.device)
        weighted, new_net_state, metrics, new_rows = _client_phase(
            updates, cfg, state, batch, client_rows, lr_t)
        if modes.is_linear(mcfg):
            # linearity shortcut: compress the reduced update once
            wire, _ = modes.client_compress(mcfg, weighted, {})
            agg = modes.aggregate(mcfg, {k: v[None] for k, v in wire.items()})
        else:
            agg = {"dense": weighted}
        agg, new_net_state, new_rows, metrics, fin_ok = _guard_nonfinite(
            cfg, agg, new_net_state, state["net_state"], new_rows, client_rows, metrics)
        if cfg.dp_noise > 0:
            # a skipped round is an empty cohort: it releases no noise
            live = metrics["participants"]
            if fin_ok is not None:
                live = live * fin_ok.to(live.dtype)
            agg = _dp_noise_agg(cfg, agg, live, state["round"])
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


def _merged_survivor_finalize(ns_sum: dict, m_sum: dict, part: torch.Tensor,
                              net_state: dict) -> tuple[dict, dict]:
    """Survivor-mean batch-norm statistics (the previous ones when nobody
    survived) and the metric sums with the participants count, from the
    merged per-client sums."""
    n_live = part.sum().clamp_min(1.0)
    alive = part.sum() > 0
    new_net_state = {k: torch.where(alive, v / n_live, net_state[k]) for k, v in ns_sum.items()}
    metrics = dict(m_sum)
    metrics["participants"] = part.sum()
    return new_net_state, metrics


def _normalize_merged_wire(mcfg: ModeConfig, wire_sum: dict, n_live: torch.Tensor) -> dict:
    """Survivor normalisation in wire space, after the merge."""
    if mcfg.agg_op == "sum":
        return dict(wire_sum)
    return {k: v / n_live for k, v in wire_sum.items()}


def make_payload_round_steps(loss_fn: Callable, cfg: EngineConfig,
                             layout: FlatLayout) -> tuple[Callable, Callable]:
    """The wire-payload round as two steps, the shape a serving deployment
    has (the reference's ``make_payload_round_steps`` with no mesh):

        client_step(state, batch) -> (tables [W, r, c], nstates, mvals, part)
        merge_step(state, tables, nstates, mvals, part, arrived, lr)
            -> (state', metrics)

    ``client_step`` is "the clients": one vmap of all W clients' updates
    (``make_client_updates``; ``client_chunk`` does not apply), each row
    clipped to ``dp_clip`` and sketched into its own [r, c] table, row by
    row in cohort order (on the card, one ``sketch_accumulate`` launch per
    client: what the reference's ``sequential_vmap`` lowers to). The
    [W, d] stack of updates is live, as in the reference. ``nstates`` and
    ``mvals`` are each client's batch-norm statistics and metric sums,
    stacked on [W]; ``part`` is the validity mask times the participation
    mask.

    ``merge_step`` is "the server": it sees only the tables and the small
    per-client rows. ``arrived`` is the serving layer's 0/1 admission mask
    (ones in the batch round): a rejected or missing payload is a zero row
    under a 0 weight, exactly a dropped client. The merge is the masked
    ordered sum over the client axis (``modes.merge_partial_wires``),
    survivor normalisation in wire space, the non-finite guard and
    ``modes.server_step_sparse`` (one query launch on the card).

    The batch round composes the two (``compose_payload``); the serving
    layer round-trips each client's table through the transport between
    them. float32 framing is exact and both run these two functions, which
    is what makes a served payload round bitwise the batch round that
    drops the same clients. There is no compress-once shortcut here: the
    sum of W tables is another float association than the sketch of the
    summed update, so payload params are not bit-comparable to the
    announce round's.

    The reference's quarantine screen, adversarial transform, stale-fold
    slots and edge variants are not ported (ROADMAP items 10 and 9b)."""
    mcfg = cfg.mode
    updates = make_client_updates(loss_fn, cfg, layout)

    def client_step(state: dict, batch: dict):
        batch, W, part = _cohort_part(cfg, state, batch)
        u, nstates, mvals = updates(state, batch, None, range(W))
        u = _clip_rows(cfg, u)
        # row by row, in cohort order: what the reference's sequential_vmap
        # of the accumulate lowers to
        tables = torch.stack([modes.client_compress(mcfg, u[w], {})[0]["table"]
                              for w in range(W)])
        return tables, nstates, mvals, part

    def merge_step(state: dict, tables: torch.Tensor, nstates: dict, mvals: dict,
                   part: torch.Tensor, arrived: torch.Tensor, lr):
        part = part * arrived
        wire_sum = modes.merge_partial_wires(mcfg, {"table": modes.mask_rows(part, tables)})
        agg = _normalize_merged_wire(mcfg, wire_sum, part.sum().clamp_min(1.0))
        new_net_state, metrics = _merged_survivor_finalize(
            {k: modes.mask_rows(part, v).sum(0) for k, v in nstates.items()},
            {k: modes.mask_rows(part, v).sum(0) for k, v in mvals.items()},
            part, state["net_state"])
        agg, new_net_state, _, metrics, _ = _guard_nonfinite(
            cfg, agg, new_net_state, state["net_state"], {}, {}, metrics)
        # dp_noise is refused with mode=sketch (EngineConfig)
        delta, mode_state = modes.server_step_sparse(mcfg, agg, state["mode_state"], lr)
        new_state = {
            "params": modes.apply_delta(state["params"], delta),
            "net_state": new_net_state,
            "mode_state": mode_state,
            "round": state["round"] + 1,
        }
        return new_state, metrics

    return client_step, merge_step


def compose_payload(client_step: Callable, merge_step: Callable) -> Callable:
    """The payload pair as a round step with ``make_round_step``'s
    signature, the batch round of a ``wire_payloads`` session: the client
    tables flow straight into the merge with every invitee arrived. Client
    rows pass through (the payload round keeps no client state)."""

    def step(state: dict, batch: dict, client_rows: dict, lr):
        pflat = state["params"]
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32,
                                                           device=pflat.device)
        tables, nstates, mvals, part = client_step(state, batch)
        new_state, metrics = merge_step(state, tables, nstates, mvals, part,
                                        torch.ones_like(part), lr_t)
        return new_state, client_rows, metrics

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
            _, aux = loss_fn(layout.unflatten(pflat), net_state, batch, None)
        return aux["metrics"]

    return evaluate
