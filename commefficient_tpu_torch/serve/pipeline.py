"""The always-on serving pipeline (``--serve_pipeline``): the port's copy
of the JAX package's ``serve/pipeline.py``. A round's preparation runs
ahead of the merge.

The serial served source runs the whole invite -> collect -> close ->
prep cycle inside ``ServedSource.next()`` on the dispatch thread, so the
device waits out every close between a round's commit and the next
dispatch. ``RoundPipeline`` runs the same calls, ``service.serve_round(s)``
for s = start, start + 1, ..., on one worker thread and parks the finished
(PreparedRound, ClosedRound) pairs in a bounded hand-off buffer (depth 2:
one round buffered, one in flight). The run loop's ``next()`` pops a ready
round, so the commit-to-dispatch gap (``RunStats.server_idle_ms``)
shrinks to a queue pop, and round s + 1's collect overlaps round s's merge
on the device.

Why it stays bitwise the serial source:

- **One producer, in round order.** The worker is the one thread that
  calls sample_cohort, prepare_served_round and finish_served_payload, in
  round order: the host draws, the requeue and the fault sites are the
  serial ones; only when they run changes.
- **The dispatch gate.** A payload round's client step reads the newest
  dispatched server state. The worker waits before round s's client step
  until the run loop reports round s - 1's merge dispatched
  (``on_dispatched``): the state the serial source read. An announce round
  reads no server state while it is prepared and does not wait. The client
  step runs on the device's default stream, the one the merges run on, so
  it is queued behind the merge it reads.
- **The committed boundary.** The worker records each pending-buffer
  boundary right after its round (where the serial source records it),
  and ``stop()`` joins the worker before the run loop's exit rewind, so
  rounds prepared but never committed unwind through the rewinds of the
  host RNG, the requeue and the pending buffer.

On a group of ranks every rank runs a pipeline: rank 0's worker serves
the service's rounds, the others' their follower's. Every collective the
worker issues goes on the serve cycle's own groups, and every collective
the main thread issues (the dispatch and its merges, the eval, the F1
decode, the checkpoint's gathers) on the original ones, so no collective
of one thread can pair with one of the other's: the go/stop flag and the
close's broadcast on the whole job's serve group
(``parallel.distributed.serve_group``), and the payload client step's
gather on the serve cycle's client-axis group and, on a mesh with seq or
model ranks, its model's collectives on the serve cycle's seq and model
groups (``distributed.serve_axis_group``, ``serve_parallel_axes``). The
stop is agreed: before each
round, before any other collective of it, rank 0's worker broadcasts
whether the round is served (``agree_round``); a stopping rank 0 says no,
and every worker ends at that round. A worker whose own rank is stopping
still follows rank 0's word, serving (and discarding) a round rank 0
started, so no rank is ever left waiting in a collective.
"""

from __future__ import annotations

import collections
import sys
import threading

import torch

from ..obs import trace as obtrace


class RoundPipeline:
    """See the module docstring. ``depth`` counts the rounds the worker may
    run ahead of the consumer: one buffered and one in flight at the
    default 2 (a deeper pipeline buys nothing, the merge takes rounds one
    at a time, and widens the preemption rewind)."""

    def __init__(self, service, start_round: int, depth: int = 2):
        if depth < 2:
            raise ValueError(f"pipeline depth must be >= 2, got {depth}")
        self.service = service
        self._cv = threading.Condition()
        self._buf: collections.deque = collections.deque()
        self._buffered = depth - 1  # beside the one in flight
        self._start = start_round
        # the newest round the run loop dispatched (the gate's watermark):
        # round start computes against the committed state
        self._dispatched = start_round - 1
        self._stop = False
        self._err: BaseException | None = None
        # the intra-op thread count the serial source computes with: a new
        # thread's OpenMP and MKL start at the core count, and a matrix
        # product split over another count sums in another order
        self._threads = torch.get_num_threads()
        self._thread = threading.Thread(target=self._run, name="serve-pipeline", daemon=True)

    def start(self) -> "RoundPipeline":
        self.service._compute_gate = self._gate
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker and join it: the run loop's exit rewind must not
        race a preparation in flight. The longest wait is a wall-clock close
        (bounded by the service's deadline) or, on a group, rank 0's word
        (bounded by the serve group's timeout)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        wait = 30.0 + float(self.service.cfg.deadline_s)
        if getattr(self.service, "group", None) is not None:
            from ..parallel import distributed

            wait += distributed.TIMEOUT_S
        self._thread.join(timeout=wait)
        if self._thread.is_alive():
            print(f"serve: WARNING - the pipeline's worker is still running {wait:.0f} s "
                  "after its stop", file=sys.stderr, flush=True)
        self.service._compute_gate = None

    # -- the run loop's side ---------------------------------------------

    def next(self):
        """The next (PreparedRound, ClosedRound) in round order; waits only
        while the worker has not finished that round. A worker's error is
        raised here."""
        with self._cv:
            self._cv.wait_for(lambda: self._buf or self._err is not None or self._stop)
            if self._buf:
                item = self._buf.popleft()
                self._cv.notify_all()
                return item
            if self._err is not None:
                raise self._err
            raise RuntimeError("the serving pipeline stopped while the run loop waited for "
                               "its next round")

    def on_dispatched(self, rnd: int) -> None:
        """Round ``rnd``'s merge is dispatched: the worker may compute round
        rnd + 1's tables."""
        with self._cv:
            if rnd > self._dispatched:
                self._dispatched = rnd
                self._cv.notify_all()

    # -- the worker's side -----------------------------------------------

    def _gate(self, rnd: int) -> None:
        """Before round ``rnd``'s client step: wait for round rnd - 1's
        dispatch (or the stop, after which nothing the step computes is
        used)."""
        with self._cv:
            self._cv.wait_for(lambda: self._dispatched >= rnd - 1 or self._stop)

    def _run(self) -> None:
        session = self.service.session
        torch.set_num_threads(self._threads)
        if session.device.type == "cuda":
            torch.cuda.set_device(session.device)
        s = self._start
        try:
            while True:
                with self._cv:
                    self._cv.wait_for(lambda: len(self._buf) < self._buffered or self._stop)
                    stopping = self._stop
                if not self.service.agree_round(s, stopping):
                    return
                with obtrace.span("serve-pipeline", "serve_round", round=s):
                    prep, closed = self.service.serve_round(s)
                with self._cv:
                    if not self._stop:
                        # the pending-buffer boundary at the serial
                        # source's point: right after round s's open
                        self.service._record_boundary(s + 1)
                        self._buf.append((prep, closed))
                        self._cv.notify_all()
                    # stopped: deliver nothing and touch no shared state;
                    # the run loop's rewind cleans up after the round
                s += 1
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            with self._cv:
                self._err = e
                self._cv.notify_all()
