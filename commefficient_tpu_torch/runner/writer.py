"""Asynchronous checkpoint writer: periodic saves off the round path, the
port's copy of the JAX package's ``runner/writer.py``.

A scheduled ``--checkpoint_every`` save copies the server state to the host
and writes, hashes and reads back about 47 MB. The writer moves that to a
thread of its own. It is safe to overlap: ``utils.checkpoint.save`` takes
a consistent (state, round, RNG snapshot) view under the session's
``mutate_lock``, copies it on a CUDA stream of its own, and commits by
rename, so a torn write is never mistaken for a checkpoint.

- ``request()`` coalesces: a request arriving while a save runs marks one
  follow-up save, which captures the newest committed state then.
- ``drain()`` blocks until idle and re-raises the first stored failure.
- ``close()`` finishes outstanding work and stops the thread.
- Emergency (watchdog) and preemption saves do not go through the writer:
  they run synchronously where "the save completed" must hold before the
  next action.
"""

from __future__ import annotations

import sys
import threading


class AsyncCheckpointWriter:
    def __init__(self, save_fn, alert=None):
        """save_fn: zero-arg callable performing one checkpoint save.
        alert: callable(str) for failure messages (default: stderr)."""
        self._save_fn = save_fn
        self._alert = alert or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self._cv = threading.Condition()
        self._pending = False
        self._busy = False
        self._closed = False
        self._error: BaseException | None = None
        self.saves_completed = 0
        self.saves_coalesced = 0
        self.last_path = None
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def request(self) -> None:
        """Ask for one save of the newest committed state."""
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            if self._pending or self._busy:
                self.saves_coalesced += 1
            self._pending = True
            self._cv.notify_all()

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:  # closed, nothing queued
                    return
                self._pending = False
                self._busy = True
            try:
                path = self._save_fn()
                with self._cv:
                    self.saves_completed += 1
                    self.last_path = path
            except BaseException as e:  # noqa: BLE001 — surfaced at drain()
                with self._cv:
                    if self._error is None:
                        self._error = e
                self._alert(f"async-checkpoint: save FAILED ({type(e).__name__}: {e}); the "
                            "failure re-raises at the next drain")
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def drain(self) -> None:
        """Block until no save is queued or running; re-raise a stored
        failure (once)."""
        with self._cv:
            while self._pending or self._busy:
                self._cv.wait()
            if self._error is not None:
                e, self._error = self._error, None
                raise e

    def close(self) -> None:
        """Finish outstanding work and stop the thread (drain first to have
        errors re-raised; close itself never raises)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60.0)
