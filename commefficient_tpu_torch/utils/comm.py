"""Communication accounting — bytes up/down per round per mode. Copied from
the JAX package's ``utils/comm.py``.

The reference's headline claim is the accuracy-vs-communication trade-off
(SURVEY.md §6 row 4: FetchSGD dominates local_topk/FedAvg at high client
counts).  In the simulator nothing actually crosses a WAN, so the cost model
is analytic, using the wire formats a real deployment of each mode would
send (matching the paper's accounting):

- sketch:        up = r*c floats per client; down = k (index, value) pairs
- true_topk:     up = d floats (dense);      down = k pairs
- local_topk:    up = k pairs;               down = up to min(W*k, d) pairs
                 (union of client supports after server aggregation; the
                 static figure is the no-server-momentum worst case — per
                 round the engine reports the broadcast delta's measured
                 support via the `down_support` metric and
                 FederatedSession.run_round substitutes it, capped at the
                 dense-float cost since virtual momentum / DP noise can
                 densify the delta past the sparse-encoding crossover)
- fedavg/localSGD: up = d floats (weight delta); down = d floats
- uncompressed:  up = d floats;              down = d floats
"""

from __future__ import annotations

from ..modes.config import ModeConfig

BYTES_F32 = 4
BYTES_PAIR = 8  # int32 index + float32 value


def bytes_up_per_client(cfg: ModeConfig) -> int:
    if cfg.mode == "sketch":
        return cfg.num_rows * cfg.num_cols * BYTES_F32
    if cfg.mode == "local_topk":
        return cfg.k * BYTES_PAIR
    return cfg.d * BYTES_F32  # true_topk / fedavg / localSGD / uncompressed


def bytes_down_per_client(cfg: ModeConfig, num_workers: int) -> int:
    if cfg.mode in ("sketch", "true_topk"):
        return cfg.k * BYTES_PAIR
    if cfg.mode == "local_topk":
        return min(num_workers * cfg.k, cfg.d) * BYTES_PAIR
    return cfg.d * BYTES_F32


def round_comm_mb(cfg: ModeConfig, num_workers: int) -> dict:
    up = bytes_up_per_client(cfg) * num_workers
    down = bytes_down_per_client(cfg, num_workers) * num_workers
    return {
        "comm_up_mb": up / 1e6,
        "comm_down_mb": down / 1e6,
        "comm_total_mb": (up + down) / 1e6,
    }
