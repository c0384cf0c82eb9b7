"""The table ring's slot protocol, numpy and the standard library only: the
part of a ring block that the in-process ``RingBlock`` (``serve/ring.py``)
and the shared-memory ``ShmRingBlock`` (``serve/scale/shmring.py``, which
a shard worker process writes) have in common.

A block is a [capacity, r, c] float32 array of tables (``tables``) and the
state of each slot: the cohort position of a committed slot
(``positions``, -1 otherwise), whether it holds an admitted table
(``valid``), whether its bytes are final (``_final``), and how many slots
were acquired (``count``, kept in a one-element int64 array so that a
shared-memory block keeps it in the segment). A decode ``acquire``s a slot
and writes the table into it (``RingSlot.write``); the admission then
``commit``s the slot at the client's cohort position or ``reject``s it,
zeroed back. A slot is never reused within a round, so a finalized slot's
bytes do not change until the block's next ``reset``, which first waits
for the block's last copy to the device (``upload_done``, an event the
service's uploader sets; anything with ``synchronize()``). When every slot
is taken ``acquire`` returns None (counted as ``serve_ring_overflow_total``)
and the admission registers a table of its own with ``add_extra``.
"""

from __future__ import annotations

import threading

import numpy as np

from ..obs import registry as obreg


class RingSlot:
    """One acquired slot of a block, where one submission's decoded table
    lands."""

    __slots__ = ("block", "index")

    def __init__(self, block: "SlotBlock", index: int):
        self.block = block
        self.index = index

    def write(self, arr) -> np.ndarray:
        """Copy a decoded [r, c] table into this slot (the assignment casts
        the wire's little-endian float32 to float32 bit for bit) and return
        the slot's view: downstream holds the view, never a table of its
        own."""
        self.block.tables[self.index][...] = arr
        return self.block.tables[self.index]


class SlotBlock:
    """The slot state machine over arrays a subclass provides (``_bind``).
    Thread-safe: decodes acquire, commit and reject from transport or
    gauntlet threads while an uploader polls ``final_prefix``. The block's
    lock is a leaf: the ingest queue's lock may be held while it is taken,
    never the reverse."""

    def _bind(self, tables: np.ndarray, positions: np.ndarray, valid: np.ndarray,
              final: np.ndarray, count: np.ndarray) -> None:
        self.tables, self.positions, self.valid = tables, positions, valid
        self._final, self._count = final, count
        self.capacity = int(len(positions))
        self.rows, self.cols = int(tables.shape[1]), int(tables.shape[2])
        self.rnd = -1
        self.extras: list[tuple[int, np.ndarray]] = []
        self._watermark = 0  # the finalized prefix found so far
        # the event after the block's last copy to the device; reset waits
        # on it before it rewrites the bytes
        self.upload_done = None
        self._cv = threading.Condition()

    @property
    def count(self) -> int:
        """Slots acquired (frozen once the round closes)."""
        return int(self._count[0])

    def wait_upload(self) -> None:
        """Wait out the block's last copy to the device (none: no wait)."""
        if self.upload_done is not None:
            self.upload_done.synchronize()
            self.upload_done = None

    def reset(self, rnd: int) -> None:
        """Re-arm the block for round ``rnd``: wait out its last copy to the
        device, zero it (the exact +0.0 every untouched slot must read as)
        and clear its state."""
        self.wait_upload()
        with self._cv:
            self.tables[...] = 0.0
            self.positions[...] = -1
            self.valid[...] = False
            self._final[...] = False
            self._count[0] = 0
            self.rnd = int(rnd)
            self.extras = []
            self._watermark = 0

    def acquire(self) -> RingSlot | None:
        """The next free slot; None when the block is full (counted)."""
        with self._cv:
            i = self.count
            if i >= self.capacity:
                obreg.default().counter("serve_ring_overflow_total").inc()
                return None
            self._count[0] = i + 1
            return RingSlot(self, i)

    def commit(self, slot: RingSlot, position: int) -> None:
        """Finalize an admitted slot at its cohort position (the bytes, then
        the position and validity, then the final flag)."""
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
        """Register an admitted table the block had no slot for, so the
        close still lands it."""
        with self._cv:
            self.extras.append((int(position), table))

    def final_prefix(self) -> int:
        """The length of the finalized prefix of the slots: what an uploader
        may ship now."""
        with self._cv:
            w, n = self._watermark, self.count
            while w < n and self._final[w]:
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
