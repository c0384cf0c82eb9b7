"""The shared-memory table ring: where a shard worker process's validated
tables land for the root (the port's copy of the JAX package's
``serve/scale/shmring.py``).

With ``--serve_shard_mode process`` the decode, the validation and the
admission run in worker processes (``procshard.py``), so the fast path's
"write each validated table once" has to hold across a process boundary.
``ShmRingBlock`` speaks the ring's slot protocol (``serve/slots.py``:
acquire, commit, reject, add_extra, final_prefix, wait_final, snapshot; a
slot is never reused within a round, a rejected slot is zeroed back) over
one ``multiprocessing.shared_memory`` segment, so the bytes the worker's
validation writes are the bytes the root's uploader copies to the device
and its close reads: the shard's hand-off is the ring itself.

Ownership: the root creates the segment (``create``) and is the only one
that unlinks it (``unlink``); a worker ``attach``es by name and only
``close``s its mapping. A worker that dies (SIGKILL included) cannot remove
a segment the root still uses, and the root's teardown is the one cleanup
path. The segment's space is reserved when it is made
(``posix_fallocate``): a segment ``/dev/shm`` cannot hold raises there,
naming the bytes asked for and the bytes free, instead of a SIGBUS at a
later write.

Visibility: the worker writes a slot's bytes, then its position and
validity, then its final flag; the root reads the flags before the bytes.
On x86-64 (total store order) a flag seen set means the bytes before it
are visible; the close is ordered anyway by the control pipe's round trip
(the worker answers "close" only after ``wait_final``). Tables the ring had
no slot for (``extras``) stay in the worker and cross in the close reply;
the root grafts them back with ``adopt_extras``.

Layout of a segment: [count: int64, padded to 64 bytes | positions:
int32[cap] | valid: uint8[cap] | final: uint8[cap] | padding to 64 |
tables: float32[cap, r, c]].

Numpy and the standard library only: this module is on the worker
process's import chain.
"""

from __future__ import annotations

import os
import time
from multiprocessing import resource_tracker, shared_memory

import numpy as np

from ..slots import SlotBlock

_HEADER_BYTES = 64
SHM_DIR = "/dev/shm"


def layout(rows: int, cols: int, capacity: int) -> tuple[int, int, int, int, int]:
    """(positions offset, valid offset, final offset, tables offset, total
    bytes) of one segment: a function of the block's shape alone, so the
    creator and an attacher agree on where each field lies."""
    pos_off = _HEADER_BYTES
    valid_off = pos_off + 4 * capacity
    final_off = valid_off + capacity
    tables_off = (final_off + capacity + 63) // 64 * 64
    return pos_off, valid_off, final_off, tables_off, tables_off + 4 * capacity * rows * cols


def shm_free_bytes() -> int | None:
    """Bytes free in ``/dev/shm`` (None where there is no such mount)."""
    try:
        st = os.statvfs(SHM_DIR)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


class ShmRingBlock(SlotBlock):
    """One round's cross-process landing zone (module docstring). ``role``
    is "root" (creator, unlinker) or "worker" (attacher, writer)."""

    def __init__(self, shm: shared_memory.SharedMemory, rows: int, cols: int, capacity: int,
                 role: str):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.role = role
        self._shm = shm
        self.name = shm.name
        self.nbytes = layout(rows, cols, capacity)[4]
        # callables run before the mapping closes: the root's view of the
        # tables for the device copies (and its registration with CUDA)
        # must go first, or the mapping cannot close
        self.before_close: list = []
        pos_off, valid_off, final_off, tab_off, _ = layout(rows, cols, capacity)
        buf = shm.buf
        # typed views of the segment; every table in it passed the worker's
        # validate_payload before it was written
        self._bind(np.frombuffer(buf, np.float32, capacity * rows * cols,
                                 tab_off).reshape(capacity, rows, cols),
                   np.frombuffer(buf, np.int32, capacity, pos_off),
                   np.frombuffer(buf, bool, capacity, valid_off),
                   np.frombuffer(buf, bool, capacity, final_off),
                   np.frombuffer(buf, np.int64, 1, 0))

    @classmethod
    def create(cls, rows: int, cols: int, capacity: int) -> "ShmRingBlock":
        """The root's side: make the segment and reserve its space; raises,
        naming the bytes needed and free, when ``/dev/shm`` cannot hold it."""
        total = layout(rows, cols, capacity)[4]
        try:
            shm = shared_memory.SharedMemory(create=True, size=total)
        except OSError as e:
            raise RuntimeError(f"serve: cannot create a {total}-byte shared-memory table ring "
                               f"segment ({e}); {SHM_DIR} has {shm_free_bytes()} bytes "
                               "free") from None
        try:
            os.posix_fallocate(shm._fd, 0, total)
        except OSError as e:
            free = shm_free_bytes()
            shm.close()
            shm.unlink()
            raise RuntimeError(f"serve: {SHM_DIR} cannot hold a {total}-byte shared-memory "
                               f"table ring segment ({e}); {free} bytes free") from None
        return cls(shm, rows, cols, capacity, role="root")

    @classmethod
    def attach(cls, name: str, rows: int, cols: int, capacity: int) -> "ShmRingBlock":
        """A worker's side: map the root's segment by name (never unlinks).
        The mapping is not left registered with the worker's resource
        tracker, which would otherwise unlink the root's segment (and warn
        of a leak) when the worker exits or is killed."""
        try:
            shm = shared_memory.SharedMemory(name=name, track=False)
        except TypeError:  # before Python 3.13 attaching always registers
            shm = shared_memory.SharedMemory(name=name)
            resource_tracker.unregister(shm._name, "shared_memory")
        return cls(shm, rows, cols, capacity, role="worker")

    def rearm(self, rnd: int) -> None:
        """The root's side, for a block its live worker zeroes at the open:
        wait out the block's last copy to the device, and clear what this
        process keeps of the block's state (the finalized prefix found, the
        adopted extras). The segment's bytes are the worker's to reset."""
        self.wait_upload()
        with self._cv:
            self.rnd, self.extras, self._watermark = int(rnd), [], 0

    def adopt_extras(self, extras) -> None:
        """The root's side: take the worker's extras from its close reply, so
        ``snapshot`` keeps the ring's contract."""
        with self._cv:
            self.extras = [(int(p), np.asarray(t, np.float32)) for p, t in extras]

    def wait_final(self, timeout_s: float) -> bool:
        """Poll until every acquired slot is finalized (another process may
        be the writer, and the segment holds flags only); False on
        timeout."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._cv:
                if bool(self._final[:self.count].all()):
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.0005)

    def close(self) -> None:
        """Drop this process's mapping (either role; idempotent)."""
        hooks, self.before_close = self.before_close, []
        for hook in hooks:
            hook()
        # the numpy views hold the mapping's buffer: drop them first
        self.tables = self.positions = self.valid = self._final = self._count = None
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        """Remove the segment from /dev/shm: the root's, once, on every exit
        path of the service."""
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
