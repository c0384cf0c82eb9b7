"""Round preparation sources for the run loop: inline (sync) and a
background thread (async).

Both serve ``FederatedSession.prepare_round(rnd)`` results strictly in
round order from one producer, which keeps the host sampling stream
identical to the synchronous loop's: prepare_round is the only thing that
draws from it, and here it is only ever called sequentially from one
thread.

- **Retry replay**: a failed load restores the host RNG before its retry,
  so an injected ``data_fail`` recovered on the prefetch thread yields the
  batch a clean run sees.
- **Resume replay**: prepared but uncommitted rounds advance only the live
  stream; the checkpointed ``rng_snapshot`` moves at commit, so a
  checkpoint taken while the prefetcher is ahead resumes bit for bit.
- **Fault scheduling**: data-load faults fire inside prepare_round at the
  round being prepared, so ``stall@7`` lands on round 7 however far ahead
  the prefetcher runs. ``preempt`` fires at dispatch, on the main thread.
- **The card**: on the GPU, prepare_round pins the batch; the producer
  thread selects the session's device before it touches the card.

Errors that survive the retries propagate: the thread parks the exception
and ``next()`` re-raises it in the loop.
"""

from __future__ import annotations

import torch

from ..data.fed_dataset import ThreadedPrefetcher


class PreparedSource:
    """Inline producer (the --sync_loop path): prepare_round at the call
    point, no thread, no lookahead."""

    def __init__(self, session, start_round: int):
        self.session = session
        self._next = start_round

    def next(self):
        prep = self.session.prepare_round(self._next)
        self._next += 1
        return prep

    def stop(self):
        pass


class RoundPrefetcher(PreparedSource):
    """Background producer with a bounded queue (depth 2: double
    buffering). ``next()`` blocks until the next round is prepared (or
    re-raises its error); ``stop()`` halts and joins the producer."""

    def __init__(self, session, start_round: int, depth: int = 2):
        super().__init__(session, start_round)

        def rounds():
            if session.device.type == "cuda":
                torch.cuda.set_device(session.device)
            rnd = start_round
            while True:  # the consumer decides the end
                yield session.prepare_round(rnd)
                rnd += 1

        self._pf = ThreadedPrefetcher(rounds(), depth=depth, name="round-prefetch")

    def next(self):
        return self._pf.next()

    def stop(self):
        self._pf.stop()
