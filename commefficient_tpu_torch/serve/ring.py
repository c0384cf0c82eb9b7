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
  tables (``tables``, the numpy view of ``host``) and each slot's state
  (the slot protocol, ``serve/slots.py``, which the shared-memory block of
  the process shards, ``serve/scale/shmring.py``, speaks too).
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

from .slots import RingSlot, SlotBlock  # noqa: F401 - RingSlot is this module's name too


class RingBlock(SlotBlock):
    """One round's landing zone in process (module docstring; the slot
    protocol is ``serve/slots.py``'s)."""

    def __init__(self, rows: int, cols: int, capacity: int,
                 device: torch.device | str = "cpu"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        shape = (int(capacity), int(rows), int(cols))
        if torch.device(device).type == "cuda":
            # pinned once, for the block's life; torch raises if it cannot
            self.host = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            if not self.host.is_pinned():
                raise RuntimeError("the table ring could not pin its host block")
        else:
            self.host = torch.zeros(shape, dtype=torch.float32)
        self._bind(self.host.numpy(), np.full(shape[0], -1, np.int32), np.zeros(shape[0], bool),
                   np.zeros(shape[0], bool), np.zeros(1, np.int64))


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
