"""``torch.profiler`` capture window: ``--profile_rounds START:END`` (the
port's counterpart of the JAX package's ``obs/profiler.py``).

Whole-run profiler traces (``--profile_dir`` alone) are unusable at scale —
hours of trace for a question about one steady-state round. The window
wraps WHOLE rounds instead: the capture starts just before round START
dispatches and stops after the drain that COMMITS round END, so it covers
complete dispatch -> compute -> commit cycles of the async pipeline
(starting or stopping mid-round would split in-flight work across the
capture edge and make the profile lie).

The capture is ``torch.profiler.profile`` with CPU activity, plus CUDA
activity when the session runs on a CUDA device. At stop it is exported as
one Chrome trace into ``--profile_dir``
(``rounds_<first>_<last>.pt.trace.json``); ``covered`` holds the rounds
whose work was launched inside it (a dispatch block that overlaps the
window is taken whole, and the async loop may dispatch past END before the
drain that commits END).

Where the profiler raises (a second profiler already open, a build without
profiling support), the window degrades to a LOUD no-op: one stderr line,
and the run continues untouched — observability must never take down the
run it observes.
"""

from __future__ import annotations

import contextlib
import os
import sys


def _profile(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))


@contextlib.contextmanager
def whole_run(log_dir: str, cuda: bool = False):
    """The whole-run capture of ``--profile_dir`` without
    ``--profile_rounds``: one ``torch.profiler`` capture around the block,
    exported as ``run.pt.trace.json`` into ``log_dir`` when it ends (also on
    a preemption's exit). No-op for an empty ``log_dir``."""
    if not log_dir:
        yield
        return
    prof = _profile(cuda)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "run.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"obs: whole-run profile written to {path}", file=sys.stderr, flush=True)


def parse_rounds_spec(spec: str) -> tuple[int, int] | None:
    """'START:END' (inclusive, 0-based global round indices) -> (start,
    end); None for empty. Malformed specs raise ValueError at launch — a
    typo must not surface hours later as a silently-missing capture."""
    if not spec or not spec.strip():
        return None
    head, sep, tail = spec.partition(":")
    try:
        if not sep:
            raise ValueError("missing ':'")
        start, end = int(head), int(tail)
    except ValueError:
        raise ValueError(
            f"--profile_rounds expects START:END (two integers), got "
            f"{spec!r}") from None
    if start < 0 or end < start:
        raise ValueError(
            f"--profile_rounds {spec!r}: need 0 <= START <= END")
    return start, end


class ProfileWindow:
    """A ``torch.profiler`` capture around rounds [start, end].

    The run loop calls ``on_dispatch(rnd, rounds)`` before each dispatch and
    ``on_committed(committed_round)`` after each drain; ``close()`` on the
    loop's exit path force-stops a window the run ended inside. ``cuda``
    adds CUDA activity to the capture. After the stop, ``path`` is the
    exported trace (None: nothing captured) and ``covered`` the (first,
    last) rounds dispatched inside it."""

    def __init__(self, start: int, end: int, log_dir: str, cuda: bool = False):
        if not log_dir:
            raise ValueError(
                "--profile_rounds needs --profile_dir (the capture has to "
                "be written somewhere)")
        self.start = start
        self.end = end
        self.log_dir = log_dir
        self.cuda = cuda
        self.path: str | None = None
        self.covered: tuple[int, int] | None = None
        self._prof = None
        self._active = False
        self._done = False

    @classmethod
    def parse(cls, spec: str, log_dir: str,
              cuda: bool = False) -> "ProfileWindow | None":
        rounds = parse_rounds_spec(spec)
        if rounds is None:
            return None
        return cls(rounds[0], rounds[1], log_dir, cuda=cuda)

    def _note(self, msg: str) -> None:
        print(f"obs: profile window — {msg}", file=sys.stderr, flush=True)

    def on_dispatch(self, rnd: int, rounds: int = 1) -> None:
        """``rnd`` is the first round about to dispatch, ``rounds`` the size
        of the dispatch block — the capture starts as soon as a block
        OVERLAPS the window (a block cannot be split, so the capture is a
        round-aligned superset). A window entirely behind the run (resume
        past it) is declared dead LOUDLY instead of silently arming at the
        wrong rounds."""
        if self._active:
            self.covered = (self.covered[0], rnd + rounds - 1)
            return
        if self._done:
            return
        if rnd > self.end:
            self._note(
                f"rounds {self.start}:{self.end} are behind the run "
                f"(dispatching round {rnd}, e.g. a resume past the "
                "window); no capture will be taken")
            self._done = True
            return
        if rnd + rounds <= self.start:
            return  # block ends before the window opens
        try:
            prof = _profile(self.cuda)
            prof.start()
        except Exception as e:  # noqa: BLE001 — LOUD no-op by contract
            self._note(
                f"torch.profiler unavailable ({type(e).__name__}: {e}); "
                f"--profile_rounds {self.start}:{self.end} degrades to a "
                "no-op and the run continues unprofiled")
            self._done = True
            return
        self._prof = prof
        self._active = True
        self.covered = (rnd, rnd + rounds - 1)
        self._note(f"capture started at round {rnd} -> {self.log_dir}")

    def on_committed(self, committed_round: int) -> None:
        """Stop once every round of the window has COMMITTED (the drain
        published round ``end``, i.e. the session counter moved past it)."""
        if self._active and committed_round > self.end:
            self._stop(f"capture stopped after round {self.end} committed")

    def declare_unreachable(self, total_rounds: int) -> None:
        """Loud launch-time rejection: the run loop calls this when the
        window starts at or past the run's last round (the capture could
        never begin — the silently-missing-capture failure mode)."""
        self._note(
            f"--profile_rounds {self.start}:{self.end} can never fire — "
            f"the run ends at round {total_rounds} (rounds are 0-based "
            "global indices); no capture will be taken")
        self._done = True

    def close(self) -> None:
        if self._active:
            self._stop("run ended inside the window; capture stopped at exit")
        elif not self._done:
            # backstop for segment runs the launch check cannot see: the
            # loop ended before the window ever opened
            self._note(
                f"run ended before rounds {self.start}:{self.end} "
                "dispatched; no capture was taken")
            self._done = True

    def _stop(self, why: str) -> None:
        first, last = self.covered
        try:
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir,
                                f"rounds_{first}_{last}.pt.trace.json")
            self._prof.export_chrome_trace(path)
            self.path = path
            self._note(f"{why}; rounds {first}..{last} -> {path}")
        except Exception as e:  # noqa: BLE001 — LOUD no-op by contract
            self._note(f"capture stop failed ({type(e).__name__}: {e})")
        self._prof = None
        self._active = False
        self._done = True
