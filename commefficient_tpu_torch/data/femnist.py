"""FEMNIST (LEAF) federated dataset: the port's copy of the JAX package's
``data/femnist.py`` (about 3.5k natural clients, one per writer).

Reads LEAF's json shards (``all_data*.json`` with per-user ``x``/``y``)
under ``<data_root>/femnist`` when present; otherwise builds the same
deterministic synthetic set as the reference, draw for draw from one
``RandomState``: 62 class prototypes, and per writer a size, 8 favoured
classes and noisy samples of their prototypes (LEAF's non-iid shape
without a download).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .fed_dataset import FedDataset

NUM_CLASSES = 62


def _load_leaf(root: str):
    files = sorted(glob.glob(os.path.join(root, "**", "all_data*.json"), recursive=True))
    if not files:
        return None
    xs, ys, shards = [], [], []
    offset = 0
    for path in files:
        with open(path) as f:
            blob = json.load(f)
        for user in blob["users"]:
            ud = blob["user_data"][user]
            x = np.asarray(ud["x"], dtype=np.float32).reshape(-1, 28, 28, 1)
            y = np.asarray(ud["y"], dtype=np.int32)
            xs.append(x)
            ys.append(y)
            shards.append(np.arange(offset, offset + len(y)))
            offset += len(y)
    return np.concatenate(xs), np.concatenate(ys), shards


def _synthetic(num_clients: int, seed: int, per_client: tuple[int, int] = (10, 40)):
    rng = np.random.RandomState(seed)
    protos = rng.normal(0, 1.0, size=(NUM_CLASSES, 28, 28, 1)).astype(np.float32)
    xs, ys, shards = [], [], []
    offset = 0
    for _ in range(num_clients):
        n = rng.randint(*per_client)
        # writer-specific skew: a handful of favoured classes
        favoured = rng.choice(NUM_CLASSES, size=8, replace=False)
        y = favoured[rng.randint(0, 8, size=n)].astype(np.int32)
        x = protos[y] + rng.normal(0, 0.6, size=(n, 28, 28, 1)).astype(np.float32)
        xs.append(x.astype(np.float32))
        ys.append(y)
        shards.append(np.arange(offset, offset + n))
        offset += n
    return np.concatenate(xs), np.concatenate(ys), shards


def load_femnist_fed(data_root: str = "./data", num_clients: int = 3550, seed: int = 0,
                     test_frac: float = 0.1) -> tuple[FedDataset, FedDataset, int]:
    """(train, test, 62): per-writer train shards, and one test shard of
    every writer's held-out ``test_frac`` (LEAF's per-user split)."""
    loaded = _load_leaf(os.path.join(data_root, "femnist"))
    if loaded is None:
        loaded = _synthetic(num_clients, seed)
    x, y, shards = loaded

    rng = np.random.RandomState(seed + 1)
    train_shards, test_idx = [], []
    for s in shards:
        s = rng.permutation(s)
        n_test = max(1, int(len(s) * test_frac)) if len(s) > 1 else 0
        test_idx.append(s[:n_test])
        if len(s) > n_test:
            train_shards.append(s[n_test:])
    train = FedDataset(x, y, train_shards)
    test = FedDataset(x, y, [np.concatenate(test_idx)])
    return train, test, NUM_CLASSES
