"""Sketch-health estimators: does the compression still deserve its bytes?
(The port's counterpart of the JAX package's ``obs/health.py``.)

A run whose Count-Sketch is saturating, whose error-feedback accumulator
is diverging, or whose cohort is silently shrinking looks fine on every
wall-clock gauge. Two halves under one contract:

DEVICE half (the top section, plain functions on tensors): per-round
compression-quality estimators the engine computes inside the round step
at the ``--health_every N`` cadence. The cadence is decided from host data
(the prepared round's flag, ``engine.HEALTH_KEY``), never from a device
value, so an off-cadence round launches nothing and no round adds a host
sync; the results ride the round's metrics to the run loop's existing
drain. Every estimator only READS round state (out-of-place ops, never a
write into the table, the delta or the error accumulator), so a
health-armed run is bitwise equal to an unarmed one. On a CUDA table the
naive recall estimate's ``csvec.unsketch_topk`` launches the
``sketch_query`` kernel once more, as every query does.

The estimators, and what each one detects:

- ``table_mass_estimate``: mean over the r hash rows of the row's squared
  L2 — an unbiased estimate of the sketched vector's squared norm (cross
  terms cancel in expectation): the round-update energy read from the wire
  alone, which a server that never sees a dense gradient can still know.
- ``row_mass_cv``: coefficient of variation of the per-row mass estimates.
  Clean sketch: every row estimates the same ||u||^2, CV near 0. Collision
  noise grows like ||u||_2^2 / sqrt(c), so a rising CV is the
  table-saturation signal.
- ``table_occupancy``: fraction of nonzero buckets (a stuck-at-zero table
  or a degenerate hash shows here first).
- ``topk_energy`` + ``split_topk_energy_fraction``: the RECALL PROXY
  (recovered top-k energy / estimated total energy) is a bracketed
  estimate. The naive same-rows estimate (energy of the table's own
  ``unsketch_topk`` values) inflates under saturation: selection over
  noisy estimates prefers coordinates whose collision noise ran high. The
  split-row cross-estimate (select with the even hash rows, evaluate with
  the odd ones, subtract the cross-estimator's variance) makes selection
  and evaluation noise independent, so it can only miss heavy hitters and
  underestimates. The engine emits their midpoint as ``topk_mass_proxy``
  and their gap as ``topk_proxy_width``; on a dense-comparable geometry
  the midpoint agrees with the true top-k energy fraction within 0.05.

HOST half (``HealthMonitor``): the drain-side sink the session hands each
committed round's health block to — converts the already-fetched values to
floats (the drain's one copy carried them; no extra sync), feeds
``health_*`` registry gauges, emits one trace instant per health round,
keeps a bounded history for the SLO engine and the round ledger, and adds
the static wire-economics figures (uplink bytes against dense).
"""

from __future__ import annotations

import collections
import math

import torch

from ..sketch import csvec

# ---------------------------------------------------------------- device half
# Plain readers: they take tensors, return tensors, and touch no registry,
# tracer or host state.


def table_row_masses(table: torch.Tensor) -> torch.Tensor:
    """[r] squared L2 mass of each hash row (float32 accumulation)."""
    return torch.sum(torch.square(table.to(torch.float32)), dim=-1)


def table_mass_estimate(table: torch.Tensor) -> torch.Tensor:
    """Unbiased estimate of the sketched vector's squared L2 norm: the mean
    over rows of the row mass."""
    return torch.mean(table_row_masses(table))


def row_mass_cv(table: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Coefficient of variation of the per-row mass estimates (population
    standard deviation over the mean) — the collision/saturation proxy."""
    masses = table_row_masses(table)
    mean = torch.mean(masses)
    return torch.std(masses, correction=0) / torch.clamp(mean, min=eps)


def table_occupancy(table: torch.Tensor) -> torch.Tensor:
    """Fraction of table buckets holding a nonzero value."""
    return torch.mean((table != 0.0).to(torch.float32))


def topk_energy(vals: torch.Tensor) -> torch.Tensor:
    """Recovered heavy-hitter energy of a k-sparse release: sum(vals^2)."""
    return torch.sum(torch.square(vals.to(torch.float32)))


def per_row_estimates(spec: csvec.CSVecSpec, table: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """[r, n] per-hash-row point estimates of the coordinates ``idx`` — the
    raw material of the split-row cross-estimator. One gather per row;
    callers bound ``n`` so the transient never scales past the single-shot
    budget (see split_topk_energy_fraction)."""
    buckets, signs = csvec._block_hashes(spec, idx, torch.float32)
    return signs * torch.gather(table.to(torch.float32), 1, buckets)


def split_topk_energy_fraction(spec: csvec.CSVecSpec, table: torch.Tensor, k: int,
                               mass: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The PESSIMISTIC half of the recall-proxy bracket: select the top-k
    with the EVEN hash rows only, cross-estimate their energy with the ODD
    rows, and subtract the cross-estimator's known variance
    (k * mass / (c * n_odd)). Selection and estimation noise are
    independent, so this cannot inflate through noise-selected coordinates:
    it UNDERESTIMATES instead, which makes (naive, split) an (upper, lower)
    bracket of the true top-k energy fraction. Requires r >= 2.

    Memory: while the [r, d] estimate transient fits in csvec's single-shot
    budget it is materialized once; past it the d-axis is scanned in chunks
    of max(k, budget / (4 r)) coordinates with a running top-k carry of
    (selection score, cross-estimate value) pairs, so a GPT-2-sized health
    round costs O(r * chunk), never O(r * d)."""
    n_b = len(range(1, spec.r, 2))
    bias = k * mass / (spec.c * n_b)

    if spec.r * spec.d * 4 <= csvec.UNSKETCH_SINGLE_SHOT_BYTES:
        est = per_row_estimates(
            spec, table, torch.arange(spec.d, dtype=torch.int64, device=table.device))
        a, b = est[0::2], est[1::2]
        sel = torch.abs(torch.mean(a, dim=0))
        _, idx = csvec.top_k(sel, k)
        bv = torch.mean(b[:, idx], dim=0)
        energy = torch.sum(torch.square(bv)) - bias
        return torch.clamp(energy, min=0.0) / torch.clamp(mass, min=eps)

    chunk = max(k, csvec.UNSKETCH_SINGLE_SHOT_BYTES // (4 * spec.r))
    top_scores = torch.full((k,), -math.inf, dtype=torch.float32, device=table.device)
    top_bvals = torch.zeros(k, dtype=torch.float32, device=table.device)
    for start in range(0, math.ceil(spec.d / chunk) * chunk, chunk):
        idx = start + torch.arange(chunk, dtype=torch.int64, device=table.device)
        valid = idx < spec.d
        est = per_row_estimates(spec, table, torch.clamp(idx, max=spec.d - 1))
        a, b = est[0::2], est[1::2]
        score = torch.where(valid, torch.abs(torch.mean(a, dim=0)),
                            torch.full_like(idx, -math.inf, dtype=torch.float32))
        bv = torch.mean(b, dim=0)
        del est, a, b
        top_scores, ti = csvec.top_k(torch.cat([top_scores, score]), k)
        top_bvals = torch.cat([top_bvals, bv])[ti]
    energy = torch.sum(torch.square(top_bvals)) - bias
    return torch.clamp(energy, min=0.0) / torch.clamp(mass, min=eps)


def energy_fraction(part: torch.Tensor, total: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """part / max(total, eps) — the recall-proxy shape (recovered energy
    over estimated total), clamped against empty/zero rounds."""
    return part / torch.clamp(total, min=eps)


# ------------------------------------------------------------------ host half


# the keys the engine emits under the reserved "health/" metrics prefix, by
# estimator family (the JAX package's names: the monitor, the SLO engine and
# the ledger agree on them without importing the engine)
SCALAR_KEYS = (
    "grad_mass_est", "grad_norm_est", "row_mass_cv", "table_occupancy",
    "topk_mass_proxy", "topk_proxy_width", "release_energy", "release_frac",
    "verror_norm_est", "verror_ratio",
    # dense-reference extras (the fused round only — the validation arm)
    "grad_norm_true", "topk_mass_true",
)
ARRAY_KEYS = ("leaf_norms",)

HEALTH_SCHEMA_VERSION = 1


class HealthMonitor:
    """Host sink for the per-round health blocks the session pops off the
    committed metrics (``FederatedSession._publish_round_obs``). One
    instance per run; ``on_round`` is called on the drain thread with
    ALREADY-FETCHED host values, so nothing here ever syncs the device.

    ``history`` keeps a bounded (rnd, block) deque for the SLO engine and
    the ledger's health column; ``last`` is the newest block."""

    def __init__(self, mode_cfg=None, num_workers: int = 0,
                 health_every: int = 1, registry=None, history: int = 1024):
        from . import registry as obreg

        self.mode_cfg = mode_cfg
        self.num_workers = num_workers
        self.health_every = max(int(health_every), 1)
        self.registry = registry if registry is not None else obreg.default()
        self.history: collections.deque = collections.deque(maxlen=history)
        self.last: tuple[int, dict] | None = None
        # static wire economics: bytes one client uploads per round vs the
        # dense [d] upload — the compression the health block is pricing
        self.uplink_bytes_per_client = None
        self.dense_bytes_per_client = None
        if mode_cfg is not None and getattr(mode_cfg, "mode", "") == "sketch":
            r, c = mode_cfg.sketch_spec.table_shape
            self.uplink_bytes_per_client = float(r * c * 4)
            self.dense_bytes_per_client = float(mode_cfg.d * 4)

    def on_round(self, rnd: int, health: dict, metrics: dict) -> dict:
        """Fold one committed health-cadence round into the registry and the
        bounded history. ``health`` maps bare estimator names to host floats
        or lists (the engine's "health/" prefix already stripped);
        ``metrics`` is the round's finalized metrics dict (for participants).
        Returns the JSON-ready block the ledger records."""
        import numpy as np

        from . import trace as obtrace

        block: dict = {}
        for k, v in health.items():
            a = np.asarray(v)
            if a.ndim == 0:
                block[k] = float(a)
            else:
                block[k] = [round(float(x), 8) for x in a.tolist()]
        if self.uplink_bytes_per_client is not None:
            # participants == 0.0 is a REAL value (a fully-degraded round
            # uploaded nothing) — only a missing key falls back
            p = metrics.get("participants")
            uploaded = float(p) if p is not None else float(self.num_workers)
            block["uplink_bytes"] = self.uplink_bytes_per_client * uploaded
            block["uplink_vs_dense"] = (
                self.uplink_bytes_per_client
                / max(self.dense_bytes_per_client, 1.0))
        scalars = {k: v for k, v in block.items() if isinstance(v, float)}
        for k, v in scalars.items():
            self.registry.gauge(f"health_{k}").set(v)
        self.registry.counter("health_rounds_total").inc()
        obtrace.instant("federated", "health", round=rnd,
                        **{k: round(v, 6) for k, v in scalars.items()})
        self.last = (rnd, block)
        self.history.append((rnd, block))
        return block

    def series(self, key: str) -> list[float]:
        """All recorded values of one scalar estimator, oldest first."""
        return [b[key] for _, b in self.history
                if isinstance(b.get(key), float)]
