"""CIFAR-10/100 federated datasets: the port's copy of the JAX package's
``data/cifar.py``.

Loads the standard python pickle batches from disk if present (searched under
`data_root`); there is no network in this environment, so when absent we fall
back to a deterministic synthetic set with the same shapes/dtypes — the
federated machinery (sharding, modes, engine) is exercised identically either
way, and bench throughput numbers don't depend on pixel content.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .fed_dataset import FedDataset, shard_by_label, shard_iid

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], dtype=np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], dtype=np.float32)


def _load_cifar10_pickles(root: str):
    base = None
    for cand in (root, os.path.join(root, "cifar-10-batches-py")):
        if os.path.exists(os.path.join(cand, "data_batch_1")):
            base = cand
            break
    if base is None:
        return None
    def load(name):
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(d[b"labels"], dtype=np.int32)
        return x, y
    xs, ys = zip(*[load(f"data_batch_{i}") for i in range(1, 6)])
    xte, yte = load("test_batch")
    return np.concatenate(xs), np.concatenate(ys), xte, yte


def _prototypes(rng: np.random.RandomState, num_classes: int,
                separation: float) -> np.ndarray:
    """The synthetic task's true class means — first draw of the stream.
    Exposed so tests can apply the exact Bayes rule without replaying
    private RNG internals.

    Drawn at 8x8 and nearest-neighbor upsampled to 32x32: per-pixel iid
    prototypes are adversarial to a weight-sharing conv net (pooling
    averages independent per-location signals to ~zero — measured: ResNet-9
    sat at random accuracy for 600 rounds on the iid variant at separation
    0.025 while the nearest-prototype Bayes rule scored 0.86). Piecewise-
    constant 4x4 blocks carry the same total signal energy (each of the
    8*8*3 draws replicated 16x) and the identical class-conditional
    Gaussian structure — the exact Bayes rule is still nearest-prototype —
    but the signal now survives convolution and pooling, so accuracy-vs-
    communication studies measure the compression scheme, not an
    architecture-task mismatch."""
    low = rng.normal(0, 1.0, size=(num_classes, 8, 8, 3))
    return separation * low.repeat(4, axis=1).repeat(4, axis=2).astype(np.float32)


def _synthetic(num_train: int, num_test: int, num_classes: int, seed: int = 0,
               separation: float = 1.0):
    """Class-conditional Gaussian images. `separation` scales the class
    prototypes against the fixed pixel noise (sigma 0.5): at the default 1.0
    the task is trivially separable (Bayes accuracy ~1.0 — any model
    saturates, fine for smoke tests); ~0.025 puts the Bayes-optimal
    (nearest-prototype) accuracy near 0.86, so accuracy-vs-communication
    trade-off curves have headroom to differ (results/README.md)."""
    rng = np.random.RandomState(seed)
    protos = _prototypes(rng, num_classes, separation)
    def make(n):
        y = rng.randint(0, num_classes, size=n).astype(np.int32)
        x = protos[y] + rng.normal(0, 0.5, size=(n, 32, 32, 3)).astype(np.float32)
        return x.astype(np.float32), y
    return *make(num_train), *make(num_test)


def _normalize(x_uint8: np.ndarray) -> np.ndarray:
    return ((x_uint8.astype(np.float32) / 255.0) - CIFAR10_MEAN) / CIFAR10_STD


def load_cifar_fed(
    dataset: str,
    num_clients: int,
    iid: bool,
    data_root: str = "./data",
    seed: int = 0,
    synthetic_train: int = 10000,
    synthetic_test: int = 2000,
    synthetic_separation: float = 1.0,
) -> tuple[FedDataset, FedDataset, int]:
    """Returns (train FedDataset, test FedDataset, num_classes). Test set is
    sharded trivially (1 shard) — eval never uses client structure."""
    num_classes = 100 if dataset == "cifar100" else 10
    loaded = _load_cifar10_pickles(data_root) if dataset == "cifar10" else None
    if loaded is not None:
        xtr_u8, ytr, xte_u8, yte = loaded
        xtr, xte = _normalize(xtr_u8), _normalize(xte_u8)
    else:
        xtr, ytr, xte, yte = _synthetic(
            synthetic_train, synthetic_test, num_classes, seed,
            separation=synthetic_separation,
        )

    rng = np.random.RandomState(seed)
    shards = shard_iid(len(xtr), num_clients, rng) if iid else shard_by_label(ytr, num_clients)
    train = FedDataset(xtr, ytr, shards)
    test = FedDataset(xte, yte, [np.arange(len(xte))])
    return train, test, num_classes
