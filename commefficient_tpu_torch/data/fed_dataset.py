"""Federated dataset layer: the port's copy of the JAX package's
``data/fed_dataset.py``.

Client sharding is an index map over one global array: each virtual client
owns a slice of indices into (x, y). Per round the session samples W clients
and assembles a fixed-shape [W, B, ...] batch with a validity mask, so
unequal shard sizes become padding, never dynamic shapes. Batches are
gathered with numpy on the host.

The rows a client contributes are drawn as the reference's native batch
assembly draws them (``native/batch_assembly.cpp``): one splitmix64 stream
per client slot and local iteration, seeded from one ``randint(1 << 62)``
of the session's sampling stream, and Floyd's algorithm for the k distinct
picks. Both packages therefore train on the same cohorts and rows from the
same seed.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


class ThreadedPrefetcher:
    """Bounded background producer over any iterator: one daemon thread
    pulls items in order into a depth-bounded queue, so host work overlaps
    whatever the consumer blocks on. Puts give up when stopped, the end is a
    sentinel, a producer exception is parked and re-raised by ``next()``,
    and ``stop()`` joins the thread. The runner's ``RoundPrefetcher`` is
    built on it."""

    _DONE = object()

    def __init__(self, it, depth: int = 2, name: str = "prefetch"):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, args=(it,), name=name,
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-responsive bounded put; False when stopped while full."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it):
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at next()
            self._exc = e
        self._put(self._DONE)

    def next(self):
        """Next item in order; re-raises a parked producer exception;
        StopIteration when the source is exhausted."""
        item = self._q.get()
        if item is self._DONE:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def stop(self):
        """Halt and join the producer (unblocking it if the queue is full).
        Safe to call twice."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)


def splitmix64(state: int) -> int:
    """splitmix64's output for ``state`` (advanced by the golden gamma, then
    mixed): a bijective mix of 64-bit words."""
    z = (state + _GOLDEN) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class _SplitMix64:
    """The reference's per-slot row sampler (``batch_assembly.cpp``), on
    Python integers masked to 64 bits."""

    def __init__(self, seed: int):
        self.s = seed & _M64

    def next(self) -> int:
        out = splitmix64(self.s)
        self.s = (self.s + _GOLDEN) & _M64
        return out

    def below(self, n: int) -> int:
        """Uniform in [0, n) by rejection, as the reference draws it."""
        while True:
            x = self.next()
            r = x % n
            if x - r <= _M64 - (n - 1):
                return r


def _sample_distinct(rng: _SplitMix64, n: int, k: int) -> list[int]:
    """Floyd's algorithm: k distinct values of [0, n), in the reference's
    order."""
    out, seen = [], set()
    for j in range(n - k, n):
        t = rng.below(j + 1)
        if t in seen:
            t = j
        seen.add(t)
        out.append(t)
    return out


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
                     batch_size: int, local_iters: int = 1) -> dict:
        """Fixed-shape per-round batch {"x": [W, B, ...], "y": [W, B],
        "mask": [W, B]}, or with a [local_iters] axis after W when
        local_iters > 1 (the microbatches of fedavg/localSGD's local steps).
        Per (client slot w, local iteration l) a client with more than B
        examples contributes B drawn without replacement from the splitmix64
        stream of slot w * local_iters + l (see the module docstring); one
        with fewer contributes all of them and zero padding behind a 0
        mask."""
        W, L, n = len(client_ids), local_iters, batch_size
        xs = np.zeros((W, L, n) + self.x.shape[1:], dtype=self.x.dtype)
        ys = np.zeros((W, L, n) + self.y.shape[1:], dtype=self.y.dtype)
        mask = np.zeros((W, L, n), dtype=np.float32)
        self._fill_rows(rng, client_ids, n, L, xs, ys, mask)
        if L == 1:
            return {"x": xs[:, 0], "y": ys[:, 0], "mask": mask[:, 0]}
        return {"x": xs, "y": ys, "mask": mask}

    def _fill_rows(self, rng: np.random.RandomState, client_ids: np.ndarray,
                   batch_size: int, local_iters: int, out_x: np.ndarray,
                   out_y: np.ndarray, out_mask: np.ndarray | None) -> None:
        """Fill [W, L, B, ...] buffers that already hold their padding with
        the sampled rows (one ``randint(1 << 62)`` of ``rng``, then the
        per-slot splitmix64 streams), as the reference's native
        ``assemble_rows`` does; rows past a short shard keep the padding,
        and the mask (if any) is 1 on the filled rows."""
        n, L = batch_size, local_iters
        seed = int(rng.randint(1 << 62))
        for wi, cid in enumerate(client_ids):
            shard = self.client_indices[int(cid)]
            k = min(len(shard), n)
            for li in range(L):
                if len(shard) <= n:
                    take = shard
                else:
                    slot = wi * L + li + 1
                    slot_rng = _SplitMix64(seed ^ ((_GOLDEN * slot) & _M64))
                    take = shard[_sample_distinct(slot_rng, len(shard), k)]
                out_x[wi, li, :k] = self.x[take]
                out_y[wi, li, :k] = self.y[take]
                if out_mask is not None:
                    out_mask[wi, li, :k] = 1.0

    def empty_batch(self, num: int, batch_size: int, local_iters: int = 1) -> dict:
        """Stand-in batch of a degraded cohort, whose data failed to load
        after its retries: the keys and shapes ``client_batch`` returns (for
        a subclass too, which is why it assembles a real batch) from a
        private ``RandomState(0)`` and client 0, so the session's sampling
        stream does not advance. Every row sits behind a zero validity
        mask, so its content never trains."""
        return self.client_batch(np.random.RandomState(0), np.zeros(num, dtype=np.int64),
                                 batch_size, local_iters)

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
