"""Compression-mode transforms: the PyTorch twin of the JAX package's
``modes/modes.py`` for the paths the port runs (mode=sketch, FetchSGD
Alg. 1, and the uncompressed control).

- ``client_compress(cfg, update, cstate) -> (wire, cstate')``: per-client
  transform of the raw [d] update.
- ``aggregate(cfg, wires, weights) -> agg``: combine the W clients' wires
  (leading axis W) by mean or sum.
- ``server_step_sparse(cfg, agg, sstate, lr) -> (delta_wire, sstate')``:
  server momentum and error feedback; ``apply_delta`` subtracts the delta.

Wire formats: dense ``{"dense": [d]}``, sketch ``{"table": [r, c]}``, sparse
``{"idx": [k] int64, "vals": [k]}`` (idx = -1 padding allowed).
"""

from __future__ import annotations

import torch

from ..sketch import csvec
from .config import ModeConfig

PORTED_MODES = ("sketch", "uncompressed")


def _require_ported(cfg: ModeConfig) -> None:
    if cfg.mode not in PORTED_MODES:
        raise NotImplementedError(
            f"mode={cfg.mode!r} is not ported; the port runs {PORTED_MODES}")
    if cfg.server_state != "dense" and cfg.mode != "sketch":
        raise NotImplementedError("server_state='sketch' is not ported")


def init_server_state(cfg: ModeConfig, device: torch.device | str) -> dict:
    """Vvelocity / Verror: [r, c] tables for mode=sketch, else [d] vectors.
    Always present (zeros) so the step is mode-independent."""
    _require_ported(cfg)
    shape = cfg.sketch_spec.table_shape if cfg.mode == "sketch" else (cfg.d,)
    return {
        "Vvelocity": torch.zeros(shape, dtype=torch.float32, device=device),
        "Verror": torch.zeros(shape, dtype=torch.float32, device=device),
    }


def client_compress(cfg: ModeConfig, update: torch.Tensor,
                    cstate: dict) -> tuple[dict, dict]:
    """Per-client transform of the raw flat [d] update."""
    _require_ported(cfg)
    if cfg.mode == "sketch":
        return {"table": csvec.sketch_vec(cfg.sketch_spec, update)}, cstate
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
    clamped to 1 so an all-dropped round aggregates to zero."""
    _require_ported(cfg)

    def op(x):
        if weights is None:
            return x.sum(0) if cfg.agg_op == "sum" else x.mean(0)
        s = mask_rows(weights, x).sum(0)
        return s if cfg.agg_op == "sum" else s / weights.sum().clamp_min(1.0)

    if cfg.mode == "sketch":
        return {"table": op(wires["table"])}
    return {"dense": op(wires["dense"])}


def server_step_sparse(cfg: ModeConfig, agg: dict, sstate: dict,
                       lr: torch.Tensor | float) -> tuple[dict, dict]:
    """Server momentum + error feedback; returns (delta_wire, new_state).
    mode=sketch releases a k-sparse {"idx", "vals"} delta, the uncompressed
    control a dense one."""
    _require_ported(cfg)
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

    # uncompressed: plain SGD with (virtual) momentum, the control
    V = rho * sstate["Vvelocity"] + agg["dense"]
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
