"""The table ring: where the served payload round's validated tables land
with ``--serve_fastpath`` (the port's copy of the JAX package's
``serve/ring.py``).

Without the fast path a payload round copies each accepted table twice on
the host: the decode makes a table of its own, and the close stacks the
tables into the [W, r, c] block the merge copies to the device. With it,
each table is written once, straight into a slot of a preallocated block
sized by the cohort:

- ``TableRing`` keeps a small pool of reusable blocks (``depth``, 4: the
  pipelined service keeps at most two rounds open). ``open_block`` hands a
  zeroed block out at the round's invite, ``release`` takes it back once
  the round's device stack is built. On the GPU a block is one pinned host
  tensor, pinned once, when the pool makes it: a pinning failure raises,
  nothing falls back to pageable memory. On the CPU it is a plain tensor.
- ``RingBlock`` is one round's landing zone: the [capacity, r, c] float32
  tables (``tables``, the numpy view of ``host``) and each slot's state.
  A decode ``acquire``s a slot and writes the table into it
  (``RingSlot.write``, the fast path's one copy of a table); the admission
  then ``commit``s the slot at the client's cohort position or
  ``reject``s it, zeroed back, so a rejected payload stays bitwise a
  client that never submitted. A slot is never reused within a round, so
  a finalized slot's bytes do not change until the block's next ``reset``:
  the uploader (``serve/service.py``) ships the finalized prefix to the
  device while the round's window is still open, and ``reset`` waits for
  the block's last copy before it writes.
- When every slot is taken (a burst past the cohort, a client retrying
  after a rejection), ``acquire`` returns None and counts
  ``serve_ring_overflow_total``; the decode then makes a table of its own
  and the admission registers it with ``add_extra``, which the close
  lands on its own.

The ring changes where the bytes lie, never their order: the device stack
built from the ring's slots is bitwise the assembler's host stack.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..obs import registry as obreg


class RingSlot:
    """One acquired slot of a RingBlock, where one submission's decoded
    table lands."""

    __slots__ = ("block", "index")

    def __init__(self, block: "RingBlock", index: int):
        self.block = block
        self.index = index

    def write(self, arr) -> np.ndarray:
        """Copy a decoded [r, c] table into this slot (the assignment casts
        the wire's little-endian float32 to float32 bit for bit) and return
        the slot's view: downstream holds the view, never a table of its
        own."""
        self.block.tables[self.index][...] = arr
        return self.block.tables[self.index]


class RingBlock:
    """One round's landing zone (module docstring). Thread-safe: decodes
    acquire, commit and reject from transport or gauntlet threads, the
    uploader polls ``final_prefix``, the close waits in ``wait_final``. The
    block's lock is a leaf: the ingest queue's lock may be held while it is
    taken, never the reverse."""

    def __init__(self, rows: int, cols: int, capacity: int,
                 device: torch.device | str = "cpu"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.rows, self.cols = int(rows), int(cols)
        self.capacity = int(capacity)
        shape = (self.capacity, self.rows, self.cols)
        if torch.device(device).type == "cuda":
            # pinned once, for the block's life; torch raises if it cannot
            self.host = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            if not self.host.is_pinned():
                raise RuntimeError("the table ring could not pin its host block")
        else:
            self.host = torch.zeros(shape, dtype=torch.float32)
        self.tables = self.host.numpy()
        # the cohort position of each committed slot (-1: not committed)
        self.positions = np.full(self.capacity, -1, np.int32)
        # a slot holds an admitted table (commit); False: rejected or in flight
        self.valid = np.zeros(self.capacity, bool)
        # a slot's bytes are final (commit or reject): the uploader ships
        # finalized slots only
        self._final = np.zeros(self.capacity, bool)
        self.rnd = -1
        self.count = 0  # slots acquired (frozen once the round closes)
        self.extras: list[tuple[int, np.ndarray]] = []
        self._watermark = 0  # the finalized prefix found so far
        # the CUDA event after the block's last host-to-device copy; reset
        # waits on it before it rewrites the pinned bytes
        self.upload_done = None
        self._cv = threading.Condition()

    def reset(self, rnd: int) -> None:
        """Re-arm a pooled block for round ``rnd``: wait out its last copy
        to the device, zero it (the exact +0.0 every untouched slot must
        read as) and clear its state."""
        if self.upload_done is not None:
            self.upload_done.synchronize()
            self.upload_done = None
        with self._cv:
            self.tables[...] = 0.0
            self.positions[...] = -1
            self.valid[...] = False
            self._final[...] = False
            self.rnd = int(rnd)
            self.count = 0
            self.extras = []
            self._watermark = 0

    def acquire(self) -> RingSlot | None:
        """The next free slot; None when the block is full (counted)."""
        with self._cv:
            if self.count >= self.capacity:
                obreg.default().counter("serve_ring_overflow_total").inc()
                return None
            self.count += 1
            return RingSlot(self, self.count - 1)

    def commit(self, slot: RingSlot, position: int) -> None:
        """Finalize an admitted slot at its cohort position."""
        with self._cv:
            self.positions[slot.index] = int(position)
            self.valid[slot.index] = True
            self._final[slot.index] = True
            self._cv.notify_all()

    def reject(self, slot: RingSlot) -> None:
        """Finalize a rejected (or stale-admitted, copied out) slot, zeroed
        back."""
        with self._cv:
            self.tables[slot.index][...] = 0.0
            self.valid[slot.index] = False
            self._final[slot.index] = True
            self._cv.notify_all()

    def add_extra(self, position: int, table: np.ndarray) -> None:
        """Register an admitted table the ring had no slot for, so the close
        still lands it."""
        with self._cv:
            self.extras.append((int(position), table))

    def final_prefix(self) -> int:
        """The length of the finalized prefix of the slots: what the
        uploader may ship now."""
        with self._cv:
            w = self._watermark
            while w < self.count and self._final[w]:
                w += 1
            self._watermark = w
            return w

    def wait_final(self, timeout_s: float) -> bool:
        """Wait until every acquired slot is finalized (the close's barrier:
        acquires stop when the window closes, so this waits on the decodes
        in flight). False on timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: bool(self._final[:self.count].all()),
                                     timeout=timeout_s)

    def snapshot(self) -> tuple[int, np.ndarray, np.ndarray, list]:
        """(count, positions, valid, extras), copied under the lock: what
        the close's scatter reads after ``wait_final``."""
        with self._cv:
            return self.count, self.positions.copy(), self.valid.copy(), list(self.extras)


class TableRing:
    """The pool of reusable RingBlocks (module docstring): at most
    ``depth`` released blocks are kept. ``allocated`` counts the blocks
    made (pinned, on the GPU) over the ring's life."""

    def __init__(self, rows: int, cols: int, depth: int = 4,
                 device: torch.device | str = "cpu"):
        self.rows, self.cols = int(rows), int(cols)
        self.depth = int(depth)
        self.device = torch.device(device)
        self.allocated = 0
        self._lock = threading.Lock()
        self._pool: list[RingBlock] = []

    def open_block(self, rnd: int, capacity: int) -> RingBlock:
        """A zeroed block of ``capacity`` slots for round ``rnd``: a pooled
        one of that capacity when there is one, else a new one."""
        with self._lock:
            for i, blk in enumerate(self._pool):
                if blk.capacity == int(capacity):
                    block = self._pool.pop(i)
                    break
            else:
                block = None
        if block is None:
            block = RingBlock(self.rows, self.cols, int(capacity), self.device)
            with self._lock:
                self.allocated += 1
        block.reset(rnd)
        return block

    def release(self, block: RingBlock) -> None:
        """Take a block back once its round's device stack is built: nothing
        holds a view of it past that point (a late admission and a
        straggler copy out, the device stack owns its bytes)."""
        with self._lock:
            if len(self._pool) < self.depth:
                self._pool.append(block)
