"""The batched validation gauntlet: the worker pool of ``--serve_fastpath``
over the socket (the port's copy of the JAX package's
``serve/gauntlet.py``).

Without the fast path the socket engines run the whole payload validation
(base64, crc32, dtype and shape, the L2 screen) on the thread that read
the frame, one frame at a time. With it they hand the raw submissions to
this pool: a drain takes every submission waiting (up to ``MAX_BATCH``)
and pushes the block through ``IngestQueue.submit_block``, which decodes
each frame straight into the round's ring slot (``serve/ring.py``) and
screens the block in one numpy pass. A lone frame on an idle server is a
batch of one; a burst becomes a real block.

Verdicts stay per submission: ``submit_block`` returns each one's status,
bitwise the one the inline path gives, and the pool hands each to its
``done`` callback. The event-loop reactor ``submit``s and takes the
verdict on its deferred-reply list (``serve/scale/eventloop.py``), so it
never waits on a batch; the threaded engine's connection thread calls
``submit_and_wait``, a caller-runs policy: the pushing thread drains
batches itself until its own verdict lands.

``stop`` gives every waiter a verdict: the workers finish the batches they
hold, and whatever is still waiting gets CLOSED.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque

from ..obs import registry as obreg
from ..obs import trace as obtrace
from .ingest import CLOSED

# the most submissions one drain takes
MAX_BATCH = 32


class GauntletPool:
    """A small worker pool running the batched validation (module
    docstring), shared by every connection of the transport."""

    def __init__(self, queue, workers: int = 2):
        if workers < 1:
            raise ValueError(f"gauntlet workers must be >= 1, got {workers}")
        self.queue = queue
        self._cv = threading.Condition()
        self._pending: deque = deque()  # (submission, done callback)
        self._stopping = False
        self._threads = [threading.Thread(target=self._run, name=f"serve-gauntlet-{i}",
                                          daemon=True) for i in range(int(workers))]
        self._started = False

    def start(self) -> "GauntletPool":
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()
        return self

    def submit(self, sub, done) -> None:
        """Queue one undecoded submission; ``done(status)`` is called once
        with its verdict. The event loop's entry: it wakes a worker, since
        the reactor never validates itself."""
        with self._cv:
            if not self._stopping:
                self._pending.append((sub, done))
                self._cv.notify()
                return
        done(CLOSED)

    def submit_and_wait(self, sub) -> str:
        """The threaded engine's caller-runs submit: queue, then drain
        batches on this thread until this submission's verdict lands. A lone
        push validates on the pushing thread; concurrent pushes form blocks
        (a drain takes everything waiting, from every connection). Workers
        are not woken for these entries."""
        done = threading.Event()
        box: dict = {}

        def deliver(status: str) -> None:
            box["status"] = status
            done.set()

        with self._cv:
            if self._stopping:
                return CLOSED
            self._pending.append((sub, deliver))
        while not done.is_set() and self._drain_one():
            pass
        if not done.is_set():
            # another thread's batch took the entry; its verdict comes from
            # there (stop() fails every waiter CLOSED, so one always comes)
            done.wait(timeout=60.0)
        return box.get("status", CLOSED)

    def _take(self) -> list:
        batch = []
        while self._pending and len(batch) < MAX_BATCH:
            batch.append(self._pending.popleft())
        return batch

    def _drain_one(self) -> bool:
        """Validate one batch on this thread, if anything waits; False when
        nothing did."""
        with self._cv:
            if not self._pending:
                return False
            batch = self._take()
        self._process(batch)
        return True

    def stop(self, join_deadline_s: float = 5.0) -> None:
        """Stop the workers; every submission still waiting gets CLOSED."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._started:
            for t in self._threads:
                t.join(timeout=join_deadline_s)
        with self._cv:
            leftovers = list(self._pending)
            self._pending.clear()
        for _sub, done in leftovers:
            done(CLOSED)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait()
                if not self._pending:
                    return  # stopping, and nothing waits
                batch = self._take()
            self._process(batch)

    def _process(self, batch) -> None:
        """Validate one block and hand every verdict out (the workers' loop
        and the caller-runs drain both come here)."""
        t0 = time.perf_counter()
        try:
            with obtrace.span("gauntlet", "validate-block", frames=len(batch)):
                statuses = self.queue.submit_block([sub for sub, _done in batch])
        except Exception as exc:  # noqa: BLE001 - a verdict must reach every waiter
            print(f"serve: gauntlet batch failed ({exc!r}); failing {len(batch)} "
                  "submission(s) CLOSED", file=sys.stderr, flush=True)
            statuses = [CLOSED] * len(batch)
        obreg.default().histogram("serve_gauntlet_batch_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        for (_sub, done), status in zip(batch, statuses):
            done(status)
