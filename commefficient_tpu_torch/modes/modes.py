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
- ``server_step_sparse(cfg, agg, sstate, lr) -> (delta_wire, sstate')``:
  server momentum and error feedback; ``apply_delta`` subtracts the delta.

Wire formats: dense ``{"dense": [d]}``, sketch ``{"table": [r, c]}``, sparse
``{"idx": [k] int64, "vals": [k]}`` (idx = -1 padding allowed).

For the linear modes (all but local_topk) sketching and averaging commute,
so the engine compresses once on the reduced update (``is_linear``).
"""

from __future__ import annotations

import torch

from ..sketch import csvec
from .config import ModeConfig


def topk_dense(v: torch.Tensor, k: int, impl: str = "exact"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx[k], vals[k]) of the k largest-|.| coordinates of dense v, in
    ``lax.top_k``'s order (``csvec.topk_abs``)."""
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
                        trim: int, want_residual: bool = False):
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
    The reference's weighted (stale-slot) form is not ported (ROADMAP Queue
    1 item 9b)."""
    W = stacked.shape[0]
    finite = torch.isfinite(stacked).reshape(W, -1).all(dim=1)
    live = live * finite.to(live.dtype)
    expand = bcast(live, stacked)
    keyed = torch.where(expand > 0, stacked, torch.full_like(stacked, float("inf")))
    n = (live > 0).sum()
    total_w = live.sum()
    if policy not in ("median", "trimmed"):
        raise ValueError(f"unknown robust merge policy {policy!r}")
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
    # the winsorized mean: every live entry clamped into the kept window's
    # edge values, so an adversary's residual is bounded by the clean range
    v_floor = _take_row(s, win_lo.clamp(0, W - 1))
    v_ceil = _take_row(s, (n - win_lo - 1).clamp(0, W - 1))
    clamped = torch.minimum(torch.maximum(stacked, v_floor), v_ceil)
    wins = csvec.merge_tables(spec, torch.where(expand > 0, clamped * expand,
                                                torch.zeros_like(stacked)))
    wins = wins / total_w.clamp_min(1e-12)
    residual = torch.where(ok, wins - robust, torch.zeros_like(robust))
    return robust, total_w, {"residual": residual}


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
    rescales by the live count for agg_op="sum". With ``want_residual`` it
    returns ``({"table": robust}, total_weight, extras)`` with the
    winsorized residual. The reference's stale-slot union stack
    (``stale_tables``/``stale_weights``) belongs to the buffered-async
    service and is refused (ROADMAP Queue 1 item 9b)."""
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
        if stale_tables is not None or stale_weights is not None:
            raise ValueError("the per-buffer robust merge over stale slots belongs to the "
                             "buffered-async service, which is not ported (ROADMAP Queue 1 "
                             "item 9b)")
        spec = cfg.sketch_spec
        if want_residual:
            robust, total_w, extras = _robust_table_merge(spec, stacked["table"], live,
                                                          policy, trim, want_residual=True)
            return {"table": robust}, total_w, extras
        return {"table": _robust_table_merge(spec, stacked["table"], live, policy, trim)}
    if cfg.mode == "sketch":
        return {"table": csvec.merge_tables(cfg.sketch_spec, stacked["table"])}
    return {"dense": stacked["dense"].sum(0)}


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
