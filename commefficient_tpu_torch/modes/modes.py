"""Compression-mode transforms: the PyTorch twin of the JAX package's
``modes/modes.py``: FetchSGD (mode=sketch, Alg. 1), its baselines
(true_topk, local_topk, fedavg/localSGD) and the uncompressed control.

- ``client_compress(cfg, update, cstate) -> (wire, cstate')``: per-client
  transform of the raw [d] update (a gradient, or a weight delta for
  fedavg/localSGD).
- ``aggregate(cfg, wires, weights) -> agg``: combine the W clients' wires
  (leading axis W) by mean or sum.
- ``merge_partial_wires(cfg, stacked, policy=...)``: the ordered sum of
  stacked wires, or the Byzantine-robust trimmed mean or median of
  per-client tables (``_robust_table_merge``).
- ``edge_grouped_sum`` / ``merge_edge_partials``: the edge tree's two-level
  fold of per-client tables (``--serve_edges``).
- ``server_step_sparse(cfg, agg, sstate, lr) -> (delta_wire, sstate')``:
  server momentum and error feedback; ``apply_delta`` subtracts the delta.

Wire formats: dense ``{"dense": [d]}``, sketch ``{"table": [r, c]}``, sparse
``{"idx": [k] int64, "vals": [k]}`` (idx = -1 padding allowed).

For the linear modes (all but local_topk) sketching and averaging commute,
so the engine compresses once on the reduced update (``is_linear``).
"""

from __future__ import annotations

import torch

from ..obs import trace as obtrace
from ..sketch import csvec
from .config import ModeConfig


@obtrace.spanned("federated", "sketch.topk")
def topk_dense(v: torch.Tensor, k: int, impl: str = "exact"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx[k], vals[k]) of the k largest-|.| coordinates of dense v,
    selected by ``impl`` (``csvec.topk_abs``)."""
    idx = csvec.topk_abs(v, k, impl=impl)
    return idx, v[idx]


def is_linear(cfg: ModeConfig) -> bool:
    return cfg.mode != "local_topk"


def init_server_state(cfg: ModeConfig, device: torch.device | str) -> dict:
    """Vvelocity / Verror: [r, c] tables for mode=sketch and for
    server_state="sketch", else [d] vectors. Always present (zeros) so the
    step is mode-independent."""
    sketched = cfg.mode == "sketch" or cfg.server_state == "sketch"
    shape = cfg.sketch_spec.table_shape if sketched else (cfg.d,)
    return {
        "Vvelocity": torch.zeros(shape, dtype=torch.float32, device=device),
        "Verror": torch.zeros(shape, dtype=torch.float32, device=device),
    }


def _local_keys(cfg: ModeConfig) -> list[str]:
    if not cfg.needs_local_state:
        return []
    return ([k for k, t in (("error", cfg.error_type), ("momentum", cfg.momentum_type))
             if t == "local"])


def init_client_state(cfg: ModeConfig, num_clients: int | None = None,
                      device: torch.device | str = "cpu") -> dict | None:
    """[num_clients, d] local error and/or momentum for local_topk with
    client-local state, else None."""
    keys = _local_keys(cfg)
    if not keys:
        return None
    n = num_clients if num_clients is not None else cfg.num_clients
    if n <= 0:
        raise ValueError("local state requires num_clients > 0")
    return {k: torch.zeros((n, cfg.d), dtype=torch.float32, device=device) for k in keys}


def empty_client_row(cfg: ModeConfig, device: torch.device | str = "cpu") -> dict:
    """A zero per-client state row ({} for modes without local state)."""
    return {k: torch.zeros(cfg.d, dtype=torch.float32, device=device)
            for k in _local_keys(cfg)}


def client_compress(cfg: ModeConfig, update: torch.Tensor,
                    cstate: dict) -> tuple[dict, dict]:
    """Per-client transform of the raw flat [d] update; ``cstate`` is this
    client's row of the local state ({} when the mode keeps none)."""
    if cfg.mode == "sketch":
        return {"table": csvec.sketch_vec(cfg.sketch_spec, update)}, cstate
    if cfg.mode == "local_topk":
        acc = update
        new_state = dict(cstate)
        if cfg.momentum_type == "local":
            acc = cfg.momentum * cstate["momentum"] + update
            new_state["momentum"] = acc
        u = cstate["error"] + acc if cfg.error_type == "local" else acc
        idx, vals = topk_dense(u, cfg.k, cfg.topk_impl)
        if cfg.error_type == "local":
            new_state["error"] = u - csvec.to_dense(cfg.d, idx, vals)
        return {"idx": idx, "vals": vals}, new_state
    # true_topk / fedavg / localSGD / uncompressed: the dense update; the
    # server step does the rest
    return {"dense": update}, cstate


def bcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a [W] per-client weight vector against [W, ...] data."""
    return w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def mask_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """NaN-safe ``x * bcast(w, x)`` for 0/1 masks: zero-weight rows are
    hard-zeroed (0 * nan would be nan), live rows keep the exact multiply."""
    wb = bcast(w, x)
    return torch.where(wb > 0, x * wb, torch.zeros_like(x))


def aggregate(cfg: ModeConfig, wires: dict, weights: torch.Tensor | None = None) -> dict:
    """Combine the W client wires (leading axis W) with cfg.agg_op. With a
    [W] 0/1 participation mask, the mean divides by the survivor count,
    clamped to 1 so an all-dropped round aggregates to zero. Sparse wires
    are densified, then reduced."""

    def op(x):
        if weights is None:
            return x.sum(0) if cfg.agg_op == "sum" else x.mean(0)
        s = mask_rows(weights, x).sum(0)
        return s if cfg.agg_op == "sum" else s / weights.sum().clamp_min(1.0)

    if cfg.mode == "sketch":
        return {"table": op(wires["table"])}
    if cfg.mode == "local_topk":
        dense = torch.stack([csvec.to_dense(cfg.d, i, v)
                             for i, v in zip(wires["idx"], wires["vals"])])
        return {"dense": op(dense)}
    return {"dense": op(wires["dense"])}


def _take_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d device integer tensor) of ``x`` along dim 0,
    without reading ``i`` on the host."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def _trimmed_keep(keyed: torch.Tensor, s: torch.Tensor, n: torch.Tensor,
                  trim: int) -> torch.Tensor:
    """[W, ...] bool: the rows that a stable ascending sort of ``keyed``
    along dim 0 (ties broken by row index) puts at ranks [trim, n - trim),
    read off the sorted values ``s`` with no second sort. With a = s[trim]
    and b = s[n - trim - 1], a row above a and below b is kept, one below a
    or above b is not, and a row equal to an edge value has the rank
    (rows below that value) + (equal rows before it), a count and a
    cumulative count along dim 0. After the sort that the median and the
    residual share, a fixed number of passes at any W. On an H100 the
    mask, its sort included, took 3.07 ms at W = 8, 7.68 at 32 and 35.99
    at 100, where ranks by counting (W passes, so W^2 work) took 1.91,
    26.51 and 251.04 and the reference's argsort of the stable order
    21.96, 25.34 and 67.24 (PERF.md §5; ``chip_smoke.py`` phase 17e times
    all three)."""
    W = keyed.shape[0]
    a = s[min(trim, W - 1)]
    b = _take_row(s, (n - trim - 1).clamp(0, W - 1))
    # an edge-tied row's rank is (rows below v) + (tied rows up to it) - 1
    lt_a, eq_a = keyed < a, keyed == a
    upto_a = torch.cumsum(eq_a, dim=0, dtype=torch.int32)
    above = ~(lt_a | eq_a) | (eq_a & (upto_a > trim - lt_a.sum(dim=0, dtype=torch.int32)))
    lt_b, eq_b = keyed < b, keyed == b
    upto_b = torch.cumsum(eq_b, dim=0, dtype=torch.int32)
    below = lt_b | (eq_b & (upto_b <= n - trim - lt_b.sum(dim=0, dtype=torch.int32)))
    return above & below & (n > 2 * trim)


def _robust_table_merge(spec, stacked: torch.Tensor, live: torch.Tensor, policy: str,
                        trim: int, want_residual: bool = False, stale_tables=None,
                        stale_weights=None):
    """Coordinate-wise Byzantine-robust location estimate over the [W, r, c]
    stacked client tables, dead rows (``live`` == 0) excluded: the robust
    MEAN (the caller rescales for agg_op="sum").

    - "median": per coordinate, the median over the live rows, with the
      quarantine's lo/hi convention (ranks (n-1)//2 and n//2; dead rows are
      keyed to +inf and indexed past).
    - "trimmed": per coordinate, rank the live rows as a stable sort would
      (``_trimmed_keep``: ties break by client index), drop the ``trim``
      lowest and ``trim`` highest live values and sum the survivors in
      client-index order through ``csvec.merge_tables`` (the sum path's
      ordered fold), divided by the survivor count.

    A live row with any non-finite value is excluded like a dead one, from
    the order statistics and from the live count. A cohort below
    2*trim+1 live rows merges to zero. The live count stays a device tensor:
    every index into the sorted stack is a device tensor, so nothing syncs.

    With ``want_residual`` it returns ``(robust, total_weight, extras)``:
    ``extras["residual"]`` is the winsorized mean minus the robust value
    (every live contribution clamped into the policy's kept window, ranks
    [trim, n-trim) for "trimmed" and the interquartile ranks for "median"),
    which the engine adds into Verror; ``total_weight`` is the live count.

    With ``stale_tables`` [n, r, c] and ``stale_weights`` [n] (the
    buffered-async service's late tables) it runs the weighted form over the
    union stack (``_weighted_table_merge``) and returns the same tuple."""
    if policy not in ("median", "trimmed"):
        raise ValueError(f"unknown robust merge policy {policy!r}")
    if stale_tables is not None:
        return _weighted_table_merge(spec, stacked, live, policy, trim, want_residual,
                                     stale_tables, stale_weights)
    W = stacked.shape[0]
    finite = torch.isfinite(stacked).reshape(W, -1).all(dim=1)
    live = live * finite.to(live.dtype)
    expand = bcast(live, stacked)
    keyed = torch.where(expand > 0, stacked, torch.full_like(stacked, float("inf")))
    n = (live > 0).sum()
    total_w = live.sum()
    # the sorted values (the median's ranks, the trimmed window's edges, the
    # residual's clamp); a tie's order does not change them
    s = torch.sort(keyed, dim=0).values
    if policy == "median":
        lo = ((n - 1) // 2).clamp(0, W - 1)
        hi = (n // 2).clamp(0, W - 1)
        med = 0.5 * (_take_row(s, lo) + _take_row(s, hi))
        robust = torch.where(n > 0, med, torch.zeros_like(med))
        ok, win_lo = n > 0, n // 4
    else:
        keep = _trimmed_keep(keyed, s, n, trim) & (expand > 0)
        kept = torch.where(keep, stacked, torch.zeros_like(stacked))
        denom = (n - 2 * trim).to(stacked.dtype).clamp_min(1.0)
        robust = csvec.merge_tables(spec, kept) / denom
        ok, win_lo = n > 2 * trim, torch.full_like(n, trim)
    if not want_residual:
        return robust
    residual = _winsorized_residual(spec, stacked, expand, s, n, win_lo, total_w, robust, ok)
    return robust, total_w, {"residual": residual}


def _winsorized_residual(spec, stacked, expand, s, n, win_lo, total_w, robust, ok):
    """The winsorized weighted mean minus the robust value: every live entry
    clamped into the kept window's edge values (sorted ranks ``win_lo`` and
    n - ``win_lo`` - 1), so an adversary's residual is bounded by the clean
    range; zero where the policy kept nothing."""
    W = stacked.shape[0]
    v_floor = _take_row(s, win_lo.clamp(0, W - 1))
    v_ceil = _take_row(s, (n - win_lo - 1).clamp(0, W - 1))
    clamped = torch.minimum(torch.maximum(stacked, v_floor), v_ceil)
    wins = csvec.merge_tables(spec, torch.where(expand > 0, clamped * expand,
                                                torch.zeros_like(stacked)))
    wins = wins / total_w.clamp_min(1e-12)
    return torch.where(ok, wins - robust, torch.zeros_like(robust))


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a 1-D tensor as a left fold, element 0 first: the same
    association on any device."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def _weighted_table_merge(spec, stacked, live, policy, trim, want_residual, stale_tables,
                          stale_weights):
    """The per-buffer robust merge of the buffered-async service (the
    reference's extended ``_robust_table_merge``): the order statistics run
    over the union stack, the cohort's [W] tables (client-index order) then
    the [n] stale slots (slot order), at weights ``live`` and
    ``stale_weights`` ((1 + lag)^-alpha). A non-finite row, a dead client
    and an empty slot weigh 0 and are excluded. Ranks are over raw values,
    so a stale outlier is trimmed like an on-time one; the weights shape
    the estimate:

    - "median": the weighted median, 0.5 * (the value at lo + the value at
      hi), lo the first sorted row whose cumulative weight is >= half the
      total and hi the first with > half. The cumulative weight is a left
      fold in sorted order, one add a row (``torch.cumsum`` of floats has
      no deterministic CUDA kernel); lo and hi count the rows below half.
    - "trimmed": the ranks [trim, n - trim) of ``_trimmed_keep``, and the
      weighted survivor mean, both sums ordered folds in union order.

    Returns ``(robust, total_weight, extras)``: the live weights' sum in
    union order, and ``stale_folded``/``stale_weight`` (the slots of
    positive weight, their weights' sum) plus ``residual`` with
    ``want_residual``. With unit weights and no slots every value is the
    unweighted form's."""
    stacked = torch.cat([stacked, stale_tables.to(stacked.dtype)])
    weights = torch.cat([live.to(torch.float32), stale_weights.to(torch.float32)])
    U = stacked.shape[0]
    finite = torch.isfinite(stacked).reshape(U, -1).all(dim=1)
    w_eff = weights * finite.to(weights.dtype)
    expand = bcast(w_eff, stacked)
    keyed = torch.where(expand > 0, stacked, torch.full_like(stacked, float("inf")))
    n = (w_eff > 0).sum()
    total_w = _ordered_sum(w_eff)
    if policy == "median":
        s, order = torch.sort(keyed, dim=0, stable=True)
        sw = w_eff[order]
        half = total_w / 2.0
        acc = torch.zeros_like(s[0])
        lo = torch.zeros(s.shape[1:], dtype=torch.int64, device=s.device)
        hi = torch.zeros_like(lo)
        for i in range(U):
            acc = acc + sw[i]
            lo = lo + (acc < half).to(torch.int64)
            hi = hi + (acc <= half).to(torch.int64)
        # no row over the mark (n == 0): index 0, as an argmax finds it
        lo = torch.where(lo >= U, torch.zeros_like(lo), lo)
        hi = torch.where(hi >= U, torch.zeros_like(hi), hi)
        med = 0.5 * (s.gather(0, lo[None])[0] + s.gather(0, hi[None])[0])
        robust = torch.where(n > 0, med, torch.zeros_like(med))
        ok, win_lo = n > 0, n // 4
    else:
        s = torch.sort(keyed, dim=0).values
        keep = _trimmed_keep(keyed, s, n, trim) & (expand > 0)
        kept_v = torch.where(keep, stacked * expand, torch.zeros_like(stacked))
        kept_w = torch.where(keep, expand.expand_as(stacked), torch.zeros_like(stacked))
        denom = csvec.merge_tables(spec, kept_w).clamp_min(1e-12)
        robust = torch.where(n > 2 * trim, csvec.merge_tables(spec, kept_v) / denom,
                             torch.zeros_like(denom))
        ok, win_lo = n > 2 * trim, torch.full_like(n, trim)
    stale_w = stale_weights.to(torch.float32)
    extras = {"stale_folded": (stale_w > 0).sum(),
              "stale_weight": (_ordered_sum(stale_w) if stale_w.shape[0]
                               else torch.zeros((), device=stale_w.device))}
    if want_residual:
        extras["residual"] = _winsorized_residual(spec, stacked, expand, s, n, win_lo,
                                                  total_w, robust, ok)
    return robust, total_w, extras


def merge_partial_wires(cfg: ModeConfig, stacked: dict, *, policy: str = "sum",
                        live: torch.Tensor | None = None, trim: int = 0,
                        stale_tables=None, stale_weights=None, want_residual: bool = False):
    """Merge wires stacked on a leading [S] axis into one: sketch tables by
    ``csvec.merge_tables`` (an ordered sum, table 0 first: the payload
    round's merge of its per-client tables), dense wires by their sum.
    Linear modes only.

    ``policy`` "trimmed"/"median" is the Byzantine-robust table merge
    (--merge_policy): the stacked leaves are per-client [W, r, c] tables,
    ``live`` the [W] 0/1 mask of clients in the merge, and the result the
    coordinate-wise robust MEAN (``_robust_table_merge``); the caller
    rescales by the live count for agg_op="sum". With ``want_residual``, or
    with the buffered-async service's ``stale_tables``/``stale_weights``
    (the weighted union stack; the caller only forwards them), it returns
    ``({"table": robust}, total_weight, extras)``."""
    if not is_linear(cfg):
        raise ValueError(f"mode={cfg.mode!r} is nonlinear: partial per-shard wires cannot be "
                         "merged by addition (per-client top-k does not commute with the "
                         "cross-shard sum)")
    if policy != "sum":
        if cfg.mode != "sketch":
            raise ValueError(f"robust merge policy {policy!r} operates on per-client "
                             f"Count-Sketch tables; mode={cfg.mode!r} has no table wire")
        if live is None:
            raise ValueError("robust merge needs the [W] live-client mask: dead rows must be "
                             "excluded from the order statistics, not counted as zero-valued "
                             "contributions")
        W = stacked["table"].shape[0]
        if policy == "trimmed" and 2 * trim >= W:
            raise ValueError(f"merge_trim={trim} would trim the whole cohort (2*{trim} >= "
                             f"W={W}); need 2*trim < num_workers")
        if (stale_tables is None) != (stale_weights is None):
            raise ValueError("the per-buffer robust merge takes the stale slots' tables and "
                             "their weights together")
        spec = cfg.sketch_spec
        if want_residual or stale_tables is not None:
            robust, total_w, extras = _robust_table_merge(
                spec, stacked["table"], live, policy, trim, want_residual=want_residual,
                stale_tables=stale_tables, stale_weights=stale_weights)
            return {"table": robust}, total_w, extras
        return {"table": _robust_table_merge(spec, stacked["table"], live, policy, trim)}
    if cfg.mode == "sketch":
        return {"table": csvec.merge_tables(cfg.sketch_spec, stacked["table"])}
    return {"dense": stacked["dense"].sum(0)}


def edge_grouped_sum(tables: torch.Tensor, live: torch.Tensor, assign, n_edges: int
                     ) -> torch.Tensor:
    """The two-tier (edge-tree) reduction of the full [W, r, c] stack: each
    edge's partial accumulated in cohort-position order, then the partials
    folded in edge order (``merge_edge_partials``), the arithmetic of the
    serving tree (``serve/scale/edge.py``) in which each edge sums its
    shard and forwards one partial.

    Both levels are explicit left folds, and client w contributes
    ``where(live[w] > 0, tables[w], 0)``: a select, never a product, so a
    lane is a fixed sequence of float32 adds, which an edge's own fold on
    the host repeats bit for bit. ``assign`` is the [W] edge of each
    position on the host (a sequence, numpy or CPU tensor): the adds run
    one client at a time, never through an atomic scatter, whose order on
    the card is undefined."""
    if tables.dim() < 1 or n_edges < 1:
        raise ValueError(f"edge_grouped_sum needs a [W, ...] stack and n_edges >= 1, got "
                         f"shape {tuple(tables.shape)}, n_edges={n_edges}")
    assign = [int(e) for e in (assign.tolist() if hasattr(assign, "tolist") else assign)]
    if len(assign) != tables.shape[0]:
        raise ValueError(f"{len(assign)} edge assignments for {tables.shape[0]} tables")
    partials = [torch.zeros(tables.shape[1:], dtype=tables.dtype, device=tables.device)
                for _ in range(n_edges)]
    zero = torch.zeros((), dtype=tables.dtype, device=tables.device)
    for w, e in enumerate(assign):
        partials[e] = partials[e] + torch.where(live[w] > 0, tables[w], zero)
    return merge_edge_partials(torch.stack(partials))


def merge_edge_partials(partials: torch.Tensor) -> torch.Tensor:
    """The [E, r, c] edge partials folded into one [r, c] table in edge
    order, from zeros (a left fold): the root of both the grouped flat twin
    and the edge-tree root merge, so the two associate alike. A dead edge's
    partial is a zero row and folds as its shard dropped."""
    if partials.dim() < 1:
        raise ValueError(f"expected [E, ...] partials, got {tuple(partials.shape)}")
    out = torch.zeros(partials.shape[1:], dtype=partials.dtype, device=partials.device)
    for e in range(partials.shape[0]):
        out = out + partials[e]
    return out


@obtrace.spanned("federated", "round.server")
def server_step_sparse(cfg: ModeConfig, agg: dict, sstate: dict,
                       lr: torch.Tensor | float) -> tuple[dict, dict]:
    """Server momentum + error feedback; returns (delta_wire, new_state).
    The top-k modes (sketch, true_topk, local_topk with virtual error)
    release a k-sparse {"idx", "vals"} delta, the others a dense one."""
    rho = cfg.momentum if cfg.momentum_type == "virtual" else 0.0

    if cfg.mode == "sketch":
        # FetchSGD Alg. 1 in sketch space
        spec = cfg.sketch_spec
        S = agg["table"]
        V = rho * sstate["Vvelocity"] + S
        E = sstate["Verror"] + lr * V
        idx, vals = csvec.unsketch_topk(spec, E, cfg.k, impl=cfg.topk_impl)
        # error subtract + momentum factor masking, in sketch space
        V, E = csvec.mask_transmitted(spec, V, E, idx, vals)
        return {"idx": idx, "vals": vals}, {"Vvelocity": V, "Verror": E}

    g = agg["dense"]

    if cfg.server_state == "sketch" and cfg.mode in ("true_topk", "local_topk"):
        # momentum and virtual error as r x c tables of the dense aggregate,
        # released by unsketch_topk as in FetchSGD; with c >= d every row is
        # a signed permutation and this equals the dense branches below
        spec = cfg.sketch_spec
        V = rho * sstate["Vvelocity"] + csvec.sketch_vec(spec, g)
        use_error = cfg.error_type == "virtual"
        E = sstate["Verror"] + lr * V if use_error else lr * V
        idx, vals = csvec.unsketch_topk(spec, E, cfg.k, impl=cfg.topk_impl)
        if use_error:
            V, E = csvec.mask_transmitted(spec, V, E, idx, vals)
            return {"idx": idx, "vals": vals}, {"Vvelocity": V, "Verror": E}
        # no error accumulator: mask V's transmitted mass only
        V = V - csvec.sketch_sparse(spec, idx, csvec.query(spec, V, idx))
        return {"idx": idx, "vals": vals}, {"Vvelocity": V, "Verror": sstate["Verror"]}

    if cfg.mode == "true_topk":
        V = rho * sstate["Vvelocity"] + g
        use_error = cfg.error_type != "none"
        E = sstate["Verror"] + lr * V if use_error else lr * V
        idx, vals = topk_dense(E, cfg.k, cfg.topk_impl)
        # masked by the selected indices, not by the values: a transmitted
        # coordinate whose value is 0 is still masked
        E = E.index_put((idx,), -vals, accumulate=True) if use_error else sstate["Verror"]
        V = V.index_fill(0, idx, 0.0)  # momentum factor masking
        return {"idx": idx, "vals": vals}, {"Vvelocity": V, "Verror": E}

    if cfg.mode == "local_topk":
        # clients already took their top-k; virtual error keeps one server
        # accumulator on the aggregate and releases its top-k
        V = rho * sstate["Vvelocity"] + g
        if cfg.error_type == "virtual":
            E = sstate["Verror"] + lr * V
            idx, vals = topk_dense(E, cfg.k, cfg.topk_impl)
            return {"idx": idx, "vals": vals}, {
                "Vvelocity": V.index_fill(0, idx, 0.0),
                "Verror": E.index_put((idx,), -vals, accumulate=True),
            }
        return {"dense": lr * V}, {"Vvelocity": V, "Verror": sstate["Verror"]}

    # fedavg / localSGD (agg is the mean weight delta; lr is the server
    # rate) and the uncompressed control: SGD with (virtual) momentum
    V = rho * sstate["Vvelocity"] + g
    return {"dense": lr * V}, {"Vvelocity": V, "Verror": sstate["Verror"]}


def apply_delta(pflat: torch.Tensor, delta: dict) -> torch.Tensor:
    """params - delta for a wire-form delta. idx = -1 padding and idx >= d
    contribute nothing: a raw -1 would wrap to pflat[d-1] and a clipped
    idx >= d would land there too."""
    if "dense" in delta:
        return pflat - delta["dense"]
    idx = delta["idx"]
    vals = delta["vals"].to(pflat.dtype)
    d = pflat.shape[0]
    safe = idx.clamp(0, d - 1)
    contrib = torch.where((idx >= 0) & (idx < d), vals, torch.zeros_like(vals))
    return pflat.index_add(0, safe, -contrib)


def delta_support(d: int, delta: dict) -> torch.Tensor:
    """Nonzero-coordinate count of the broadcast delta (local_topk's
    measured down-link). Sparse wires have unique indices, so counting
    nonzero vals counts the densified delta's nonzero coordinates."""
    target = delta["dense"] if "dense" in delta else delta["vals"]
    return torch.count_nonzero(target).to(torch.float32)


def server_step(cfg: ModeConfig, agg: dict, sstate: dict,
                lr: torch.Tensor | float) -> tuple[torch.Tensor, dict]:
    """``server_step_sparse`` with the delta densified to [d]: new params
    are ``params - delta``."""
    delta, new_state = server_step_sparse(cfg, agg, sstate, lr)
    if "dense" in delta:
        return delta["dense"], new_state
    return csvec.to_dense(cfg.d, delta["idx"], delta["vals"]), new_state
