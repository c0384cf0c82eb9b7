"""The reference's federated rounds: the cohort and its batch worked out
again from the seed, every client's gradient by plain autograd one client
at a time, their mean, and the server step of the mode.

- Cohort: ``numpy.random.RandomState(seed)`` draws each round's W clients
  without replacement (``choice``), then one ``randint(2**62)`` that seeds
  the row picks of clients holding more rows than a batch. In these
  configurations every client holds exactly one batch, so its batch is its
  rows in shard order.
- Client update: the gradient of the client's mean loss, plus weight decay
  times the parameters; the round's update is the mean over the cohort.
- ``sketch`` (FetchSGD, arXiv:2007.07682, Alg. 1): the update's sketch S;
  momentum V = rho V + S; error E += lr V; the top k coordinates of E's
  estimates by magnitude are the step; E loses the step's sketch, and V
  the sketch of its own estimates at those coordinates.
- ``uncompressed``: V = rho V + g; the step is lr V.

The server algebra runs in float64. ``precision="tf32"`` computes the
models' matrix products and convolutions in TF32 (the control), and
``clients="half"`` averages over the first half of each cohort only (a
planted fault).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import layout as rlayout
from .models import LOSSES
from .sketch import Sketch


@contextlib.contextmanager
def precision(mode: str):
    """Matrix products and convolutions in float32 ("fp32") or TF32."""
    tf32 = mode == "tf32"
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def shards(model_cfg: dict, data: dict) -> list[np.ndarray]:
    """Each client's row indices: images sorted by label (stable) and cut
    into equal shards, the non-iid split; text rows in blocks of
    ``rows_per_client``."""
    n = model_cfg["data"]["num_clients"]
    if model_cfg["data"]["kind"] == "images":
        order = np.argsort(data["y"], kind="stable")
        return np.array_split(order, n)
    per = model_cfg["data"]["rows_per_client"]
    return [np.arange(i * per, (i + 1) * per) for i in range(n)]


def cohorts(seed: int, num_clients: int, W: int, rounds: int) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rounds):
        out.append(rng.choice(num_clients, size=W, replace=False))
        rng.randint(1 << 62)
    return out


def client_batch(model_cfg: dict, data: dict, rows: np.ndarray, device) -> dict:
    if model_cfg["data"]["kind"] == "images":
        return {"x": torch.from_numpy(data["x"][rows]).to(device),
                "y": torch.from_numpy(data["y"][rows]).to(device)}
    return {k: torch.from_numpy(data[k][rows]).to(device)
            for k in ("input_ids", "token_type_ids", "labels")}


def follow(model_cfg: dict, fetch: dict, mode: str, W: int, seed: int, p0: torch.Tensor,
           data: dict, rounds: int = 3, prec: str = "fp32", clients: str = "all") -> dict:
    """Run ``rounds`` rounds from the flat float32 parameters ``p0``.
    Returns the readings the check compares: the round losses, the first
    round's mean update (dense, float64) and its sketch (sketch mode), and
    the flat parameters after the last round."""
    device = p0.device
    leaves = rlayout.leaves(model_cfg)
    loss_fn = LOSSES[model_cfg["model"]]
    rho, wd, lr = fetch["momentum"], fetch["weight_decay"], fetch["lr"]
    sk = Sketch(p0.numel(), fetch["num_cols"], fetch["num_rows"], seed)
    shard = shards(model_cfg, data)
    p = p0.clone()
    V = E = None
    losses, g1 = [], None
    for ids in cohorts(seed, len(shard), W, rounds):
        take = ids if clients == "all" else ids[:len(ids) // 2]
        params = {k: t.requires_grad_(True) for k, t in rlayout.unflatten(p, leaves).items()}
        names = list(params)
        g = torch.zeros_like(p, dtype=torch.float64)
        loss_sum, count = 0.0, 0.0
        with precision(prec):
            for cid in take:
                batch = client_batch(model_cfg, data, shard[int(cid)], device)
                loss, lsum, cnt = loss_fn(params, batch, model_cfg)
                grads = torch.autograd.grad(loss, [params[k] for k in names])
                g += rlayout.flatten(dict(zip(names, grads)), leaves).to(torch.float64)
                loss_sum += float(lsum.detach())
                count += float(cnt)
        g = g / len(take) + wd * p.to(torch.float64)
        losses.append(loss_sum / count)
        if mode == "sketch":
            S = sk.sketch(g)
            if g1 is None:
                g1 = (g, S)
            V = S if V is None else rho * V + S
            E = lr * V if E is None else E + lr * V
            est = sk.estimates(E)
            idx = torch.topk(est.abs(), fetch["k"]).indices
            step = torch.zeros_like(g)
            step[idx] = est[idx]
            E = E - sk.sketch(step)
            vq = torch.zeros_like(g)
            vq[idx] = sk.estimates(V)[idx]
            V = V - sk.sketch(vq)
        elif mode == "uncompressed":
            if g1 is None:
                g1 = (g, None)
            V = g if V is None else rho * V + g
            step = lr * V
        else:
            raise ValueError(f"the reference has no mode {mode!r}")
        p = (p.to(torch.float64) - step).to(torch.float32)
        del params, g
    return {"losses": losses, "g1": g1[0], "g1_table": g1[1], "p_last": p}

