"""Federated dataset layer: the port's copy of the JAX package's
``data/fed_dataset.py``.

Client sharding is an index map over one global array: each virtual client
owns a slice of indices into (x, y). Per round the session samples W clients
and assembles a fixed-shape [W, B, ...] batch with a validity mask, so
unequal shard sizes become padding, never dynamic shapes. Batches are
gathered with numpy on the host.
"""

from __future__ import annotations

import numpy as np


class FedDataset:
    """Global (x, y) arrays + per-client index shards (a list of 1-D int
    arrays, ragged)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, client_indices: list[np.ndarray]):
        self.x = np.ascontiguousarray(x)
        self.y = np.ascontiguousarray(y)
        self.client_indices = [np.asarray(ix, dtype=np.int64) for ix in client_indices]
        if any(len(ix) == 0 for ix in self.client_indices):
            raise ValueError("every client needs at least one example")

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    def __len__(self) -> int:
        return len(self.x)

    def sample_clients(self, rng: np.random.RandomState, num: int) -> np.ndarray:
        """Uniform without replacement over all virtual clients."""
        return rng.choice(self.num_clients, size=min(num, self.num_clients), replace=False)

    def client_batch(self, rng: np.random.RandomState, client_ids: np.ndarray,
                     batch_size: int) -> dict:
        """Fixed-shape per-round batch {"x": [W, B, ...], "y": [W, B],
        "mask": [W, B]}: a client with more than B examples contributes B
        drawn without replacement, one with fewer contributes all of them
        and zero padding behind a 0 mask."""
        W, n = len(client_ids), batch_size
        xs = np.zeros((W, n) + self.x.shape[1:], dtype=self.x.dtype)
        ys = np.zeros((W, n) + self.y.shape[1:], dtype=self.y.dtype)
        mask = np.zeros((W, n), dtype=np.float32)
        sub = np.random.RandomState(int(rng.randint(1 << 31)))
        for wi, cid in enumerate(client_ids):
            shard = self.client_indices[int(cid)]
            k = min(len(shard), n)
            take = shard if len(shard) <= n else sub.choice(shard, size=k, replace=False)
            xs[wi, :k] = self.x[take]
            ys[wi, :k] = self.y[take]
            mask[wi, :k] = 1.0
        return {"x": xs, "y": ys, "mask": mask}

    def eval_batches(self, batch_size: int):
        """Fixed-shape eval iterator over the whole set (pads the tail)."""
        n = len(self.x)
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            k = end - start
            x = np.zeros((batch_size,) + self.x.shape[1:], dtype=self.x.dtype)
            y = np.zeros((batch_size,), dtype=self.y.dtype)
            mask = np.zeros((batch_size,), dtype=np.float32)
            x[:k], y[:k], mask[:k] = self.x[start:end], self.y[start:end], 1.0
            yield {"x": x, "y": y, "mask": mask}


def shard_iid(num_examples: int, num_clients: int, rng: np.random.RandomState) -> list[np.ndarray]:
    perm = rng.permutation(num_examples)
    return [s for s in np.array_split(perm, num_clients) if len(s)]


def shard_by_label(labels: np.ndarray, num_clients: int) -> list[np.ndarray]:
    """The reference's non-iid protocol: sort by label, split into
    contiguous equal shards."""
    order = np.argsort(labels, kind="stable")
    return [s for s in np.array_split(order, num_clients) if len(s)]
