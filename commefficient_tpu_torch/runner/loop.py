"""The run loop: block planning, overlap, and the operational wiring
(watchdog, preemption, non-finite halt, eval and checkpoint cadence). The
PyTorch twin of the JAX package's ``runner/loop.py``.

Overlap (async, the default):

    prefetch thread:  prepare N+1, N+2      (cohort sampling, batch assembly,
                                             pinning)
    main thread:      dispatch N, N+1, ...  (launch every kernel of the round;
                                             no host sync)
    device:           compute N, N+1, ...   (queued behind the launches)
    writer thread:    periodic checkpoint save
    main thread at a boundary: one device-to-host copy of every pending
        round's metrics -> commit in dispatch order -> eval / log / save

In eager PyTorch a dispatch returns only after the host has launched all
of the round's kernels (about 150 per client), so it is most of the
round's host time. What the loop overlaps is the next round's preparation
on the prefetch thread with this round's launches, and the device's work
on round N with the host's launches of round N+1. The watchdog therefore
never learns from a dispatch's time, only from synced segments.

What stays synchronous, deliberately:

- **Commit order**: rounds publish (state, round counter, comm totals, RNG
  snapshot) in dispatch order under the session's ``mutate_lock``.
- **Eval**: only at a drained boundary.
- **Emergency, preemption and final saves**: where "the save completed"
  must hold before the next action (abort, exit 75, return). The async
  writer is drained first.
- **Non-finite halt**: checked from committed metrics at drain
  boundaries; the step's ``skip`` guard keeps the state clean for any round
  dispatched after the poisoned one.
- **Preemption across ranks**: in a group of ranks (the sharded round)
  the SIGTERM flag is agreed at every round-block boundary
  (``resilience.preemption.coordinated``), so every rank drains the same
  round and exits 75 together, and only rank 0 writes checkpoints; no rank
  exits before rank 0's exit checkpoint is written.

``--sync_loop`` is the serial path: inline preparation, one
prepare -> dispatch -> drain per round (or block), blocking saves. Both
paths run the same step in the same order on the same host RNG stream,
which is why the tests pin them bitwise equal.

Observability (``obs/``): the loop's phases are spans on the tracer's
``runner`` track (prepare, dispatch, drain, commit, checkpoint_sync, eval),
with a ``commit_round`` instant per committed round. Each dispatch's
deferred ``device`` span is closed by the drain that commits it
(``DeviceSpans``): on a card, from CUDA timing events recorded at the
dispatch's start and end, put on the tracer's clock after the drain's sync;
on the CPU, where a dispatch runs to its end, from the host timestamps.
Tracing adds no host sync. ``--profile_rounds`` opens a ``torch.profiler``
window (``obs.profiler.ProfileWindow``) at the dispatch of its first round
and closes it after the drain that commits its last. An SLO engine in ``halt``
mode that latched at a commit ends the run at the drain boundary through
the non-finite halt's clean exit, and the ``postmortem`` hook writes the
crash bundle on the watchdog abort and the preemption exit.

Round time: each drain closes a window that opened when the loop took
the first round after the previous drain; ``RunStats.round_ms`` holds each
window's wall time over the rounds it committed. In the sync loop a window
is one prepare -> dispatch -> drain, the synced round time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import sys
import threading
import time

import torch

from ..federated.api import FederatedSession, FedOptimizer, plan_block
from ..obs import registry as obreg
from ..obs import trace as obtrace
from ..obs.profiler import ProfileWindow
from ..parallel import distributed
from ..resilience import EXIT_RESUMABLE, PreemptionHandler, preemption
from ..resilience.faults import ADVERSARIAL_KINDS
from ..utils import checkpoint as ckpt
from ..utils.logging import Timer
from ..utils.watchdog import RoundWatchdog
from .prefetch import PreparedSource, RoundPrefetcher
from .writer import AsyncCheckpointWriter

DEFAULT_MAX_INFLIGHT = 4  # auto-tune's starting point until a round is timed
AUTO_INFLIGHT_LO, AUTO_INFLIGHT_HI = 2, 16


def measure_rtt_ms(device: torch.device, samples: int = 5) -> float:
    """Median host -> device -> host round trip of a trivial op and the copy
    of its result back: the cost of one drain's sync, which the in-flight
    chain amortises. Runs once at loop start."""
    x = torch.zeros((), device=device)
    (x + 1.0).item()  # warm
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        (x + 1.0).item()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def auto_inflight(rtt_ms: float, round_ms: float, target_overhead: float = 0.1) -> int:
    """In-flight depth that keeps the per-drain sync under about
    ``target_overhead`` of the work it amortises: each drain costs one RTT
    spread over the rounds it commits, so depth >= rtt / (target * round).
    Clamped to [2, 16]: 2 keeps dispatch and commit overlapped, 16 bounds
    what a preemption's grace window must wait out."""
    if round_ms <= 0:
        return DEFAULT_MAX_INFLIGHT
    want = math.ceil(rtt_ms / (target_overhead * round_ms))
    return max(AUTO_INFLIGHT_LO, min(AUTO_INFLIGHT_HI, want))


@dataclasses.dataclass
class RunnerConfig:
    """Loop shape and operational policy (the CLI's flags; build one with
    ``from_args`` or directly in tests)."""

    total_rounds: int
    eval_every: int
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    rounds_per_dispatch: int = 1
    sync_loop: bool = False
    # async only: drain when this many rounds are dispatched but not
    # committed. 0 = auto (auto_inflight from the measured RTT and the
    # observed round time); > 0 = fixed (--max_inflight)
    max_inflight: int = 0
    # round-preparation lookahead; 0 = auto (2, or 4 on a slow host link)
    prefetch_depth: int = 0
    on_nonfinite: str = "skip"  # "halt" stops the run at a drain
    watchdog_abort: bool = False
    no_emergency_checkpoint: bool = False
    # a torch.profiler capture window around whole rounds ("START:END";
    # empty = off) written into profile_dir (obs/profiler.py)
    profile_rounds: str = ""
    profile_dir: str = ""

    @classmethod
    def from_args(cls, args, total_rounds: int, eval_every: int):
        return cls(
            total_rounds=total_rounds, eval_every=eval_every,
            checkpoint_every=args.checkpoint_every, checkpoint_dir=args.checkpoint_dir,
            rounds_per_dispatch=args.rounds_per_dispatch, sync_loop=args.sync_loop,
            max_inflight=args.max_inflight, prefetch_depth=args.prefetch_depth,
            on_nonfinite=args.on_nonfinite, watchdog_abort=args.watchdog_abort,
            no_emergency_checkpoint=args.no_emergency_checkpoint,
            profile_rounds=getattr(args, "profile_rounds", ""),
            profile_dir=getattr(args, "profile_dir", ""))


@dataclasses.dataclass
class RunStats:
    """What one run_loop did, counted directly."""

    rounds: int = 0
    wall_s: float = 0.0
    nonfinite_rounds: int = 0
    drains: int = 0
    evals: int = 0
    sync_checkpoints: int = 0
    async_checkpoints: int = 0
    # the measured host<->device RTT (async only) and the in-flight depth
    # the loop ended on
    rtt_ms: float = 0.0
    max_inflight_used: int = 0
    # per drain: window wall ms / rounds committed, and those rounds
    round_ms: list = dataclasses.field(default_factory=list)
    window_rounds: list = dataclasses.field(default_factory=list)
    # host ms summed over the run: waiting for prepared rounds, dispatching,
    # draining (the one sync, then the commit)
    prepare_ms: float = 0.0
    dispatch_ms: float = 0.0
    drain_ms: float = 0.0
    # per checkpoint saved by the loop's own save closure: copy_ms,
    # write_ms, verify_ms (utils.checkpoint.save)
    checkpoints: list = dataclasses.field(default_factory=list)
    # cohort degradation: clients the validity mask killed (dropped or a
    # degraded load), summed over the run
    clients_dropped: int = 0
    # clients the sketch-space quarantine rejected, summed over the run
    # (also the cohort_clients_quarantined_total counter), and the
    # adversarial attacks the fault plan injected while it ran (the
    # resilience_attack_<kind>_total counters' deltas, summed)
    clients_quarantined: int = 0
    attacks_injected: int = 0
    # SLO engine firings while this loop ran (the slo_violations_total
    # registry counter's delta over the run)
    slo_violations: int = 0
    # the mean and the longest gap from a drain's commit to the next
    # dispatch: the server's idle time, which a pipelined served source
    # (its next round ready at the commit) shrinks to the dispatch call
    # itself; also the server_idle_ms gauge (the last gap) and the
    # runner_idle_ms histogram
    server_idle_ms: float = 0.0
    server_idle_ms_max: float = 0.0


class DeviceSpans:
    """The run loop's deferred spans on the tracer's ``device`` track, one
    per dispatch, emitted once the drain that commits the dispatch has
    synced.

    On a card with the tracer armed, a dispatch records a CUDA timing event
    at its start and one at its end, so its span runs from when the card
    reached the dispatch's work to when it finished it (a host timestamp
    would count the queue ahead of the dispatch as its work). The drain
    records an anchor event just after its sync, beside ``tracer.now_us()``,
    and each event's time before the anchor puts it on the tracer's clock.
    An anchor is read once it has completed: at the end of its drain if
    ``query`` says so, else at the next drain's sync, or at the loop's end
    (``flush(wait=True)``), where the last drain left nothing queued ahead
    of it. On
    the CPU, where a dispatch runs to its end, a span runs from the
    dispatch's host timestamp to the drain's."""

    def __init__(self, tracer, cuda: bool, sketch_path: str):
        self.tracer, self.cuda, self.sketch_path = tracer, cuda, sketch_path
        self._open: collections.deque = collections.deque()  # (ts_us, first, n, events)
        self._anchored: list = []  # (anchor, its trace us, [(first, n, events)])

    def event(self):
        """A timing event recorded now on a card with the tracer armed,
        else None."""
        if not (self.cuda and self.tracer.enabled):
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def dispatched(self, ts_us: float, first: int, n: int, start) -> None:
        """A dispatch of n rounds from ``first`` returned; ``ts_us`` and
        ``start`` (``event()``'s) were taken before it launched."""
        self._open.append((ts_us, first, n, None if start is None else (start, self.event())))

    def drained(self) -> None:
        """Every open dispatch's rounds are done: the drain has synced."""
        self.flush()  # an earlier drain's anchor is complete by now
        end_us = self.tracer.now_us()
        timed = []
        while self._open:
            ts_us, first, n, events = self._open.popleft()
            if events is None:
                self._emit(first, n, ts_us, end_us)
            else:
                timed.append((first, n, events))
        if timed:
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            self._anchored.append((anchor, self.tracer.now_us(), timed))

    def flush(self, wait: bool = False) -> None:
        """Emit the spans whose anchor has completed (every one with
        ``wait``)."""
        keep = []
        for anchor, anchor_us, timed in self._anchored:
            if wait:
                anchor.synchronize()
            elif not anchor.query():
                keep.append((anchor, anchor_us, timed))
                continue
            for first, n, (start, end) in timed:
                self._emit(first, n, anchor_us - start.elapsed_time(anchor) * 1e3,
                           anchor_us - end.elapsed_time(anchor) * 1e3)
        self._anchored = keep

    def _emit(self, first: int, n: int, start_us: float, end_us: float) -> None:
        self.tracer.complete("device", f"rounds {first}..{first + n - 1}", start_us,
                             end_us - start_us, round_first=first, rounds=n,
                             sketch_path=self.sketch_path)


def make_save_ckpt(session: FederatedSession, checkpoint_dir: str, timings: list | None = None):
    """The one save closure of a run: serialised by its own lock (the
    watchdog's emergency save runs on a timer thread and must not race a
    periodic save of the same round), sharing the session's fault plan and
    retry policy. Each save's timings are appended to ``timings``. One
    writer per job: in a group of ranks (whose committed states are
    bitwise equal) only rank 0 writes, and the others' saves return None;
    a split client state (``session.client_block``) is gathered to rank 0
    by every rank's save."""
    lock = threading.Lock()
    writer = distributed.rank() == 0 or session.client_block is not None

    def save_ckpt():
        if not writer:
            return None
        t: dict = {}
        with lock:
            path = ckpt.save(checkpoint_dir, session, fault_plan=session.fault_plan,
                             retry_policy=session.retry_policy, timings=t)
        if timings is not None and path is not None:
            timings.append(t)
        return path

    return save_ckpt


def run_loop(session: FederatedSession, opt: FedOptimizer, cfg: RunnerConfig, *,
             eval_fn=None, build_row=None, logger=None, save_ckpt=None,
             source=None, slo=None, postmortem=None) -> RunStats:
    """Run the training loop from session.round to cfg.total_rounds.

    eval_fn() -> metrics dict, called at every eval boundary (drained).
    build_row(rnd, m, totals, ev, time_s, nonfinite_total) -> row dict for
    the logger; ``m`` is the last round's metrics, ``totals`` the sum of
    every numeric metric since the previous eval row. Either may be None.
    save_ckpt defaults to make_save_ckpt when cfg.checkpoint_dir is set.

    ``source`` is an external round source (``next()`` -> PreparedRound in
    round order, ``stop()``; optional ``on_dispatched(round)`` and
    ``on_committed(round)`` hooks): the serving layer's ``ServedSource``,
    which makes the service, not the sampling prefetcher, the producer of
    rounds. Its preparation runs on this (the dispatch) thread, or ahead on
    its pipeline's worker, which ``on_dispatched`` tells when a round's
    merge is dispatched.

    Each prepare, dispatch, drain (the sync) and commit is observed into
    the obs registry's ``runner_phase_<phase>_ms`` histograms, which the
    serving layer's ``/metrics`` reads.

    ``slo`` is the ``obs.SloEngine`` the session feeds at each commit; the
    loop checks its halt latch at drain boundaries. ``postmortem``
    (callable(reason), ``obs.ObsWiring.postmortem``) writes the crash
    bundle on the watchdog-abort and preemption exits, where the CLIs'
    exception handling never runs (os._exit) or runs too late.

    Exits the process (raises SystemExit) on preemption (EXIT_RESUMABLE)
    and on --on_nonfinite halt, after draining and saving. On every exit
    the live host RNG is rewound to the committed boundary, so the session
    stays usable. The stats of a run that returns are also left in
    ``session.run_stats``.
    """
    stats = RunStats()
    t0 = time.perf_counter()
    eval_every = max(cfg.eval_every, 1)
    start_round = session.round
    reg = obreg.default()
    mark = reg.mark()
    tracer = obtrace.get()
    # the deferred device spans name the round variant the session runs
    device_spans = DeviceSpans(tracer, session.device.type == "cuda", session.cfg.sketch_path)
    if save_ckpt is None and cfg.checkpoint_dir:
        save_ckpt = make_save_ckpt(session, cfg.checkpoint_dir, stats.checkpoints)
    # in a group of ranks a local SIGTERM must not cut the schedule short
    # (the other ranks would wait in the next round's gather): every
    # preemption decision goes through the ranks' agreement at the block
    # boundaries, where every rank's collectives line up
    ranks = distributed.world_size()
    profile = ProfileWindow.parse(cfg.profile_rounds, cfg.profile_dir,
                                  cuda=session.device.type == "cuda")
    if profile is not None and profile.start >= cfg.total_rounds:
        # a window the run can never reach is loud at launch, not a
        # silently missing capture found later
        profile.declare_unreachable(cfg.total_rounds)
        profile = None

    def _postmortem(reason: str):
        """Best-effort crash-bundle write: the exit it precedes is the
        point, and a failing bundle must never mask it."""
        if postmortem is None:
            return
        try:
            postmortem(reason)
        except Exception as e:  # noqa: BLE001 — crash path
            print(f"runner: postmortem bundle failed ({type(e).__name__}: {e})",
                  file=sys.stderr, flush=True)

    def _abort():
        # stage 4: flush the black box, then a resumable exit that skips
        # every finally (this is the bundle's one chance)
        _postmortem("watchdog_abort")
        os._exit(EXIT_RESUMABLE)

    # a split client state's save is a collective of every rank: it runs on
    # the main thread at a round boundary, never from the watchdog's timer
    # or the writer thread, where the ranks' calls would not line up
    split = session.client_block is not None
    # escalation ladder: warn -> stacks -> emergency checkpoint -> (opt-in)
    # abort with the resumable status
    watchdog = RoundWatchdog(
        on_emergency=(save_ckpt if save_ckpt and not cfg.no_emergency_checkpoint and not split
                      else None),
        on_abort=_abort if cfg.watchdog_abort and save_ckpt else None)

    async_mode = not cfg.sync_loop
    rtt_ms = (measure_rtt_ms(session.device)
              if async_mode and (cfg.max_inflight <= 0 or cfg.prefetch_depth <= 0) else 0.0)
    eff_inflight = cfg.max_inflight if cfg.max_inflight > 0 else DEFAULT_MAX_INFLIGHT
    prefetch_depth = (cfg.prefetch_depth if cfg.prefetch_depth > 0
                      else (4 if rtt_ms > 10.0 else 2))
    ema_round_ms = 0.0
    stats.rtt_ms = rtt_ms
    writer = (AsyncCheckpointWriter(save_ckpt)
              if async_mode and save_ckpt and cfg.checkpoint_every and not split else None)
    src = source if source is not None else (
        RoundPrefetcher(session, start_round, depth=prefetch_depth) if async_mode
        else PreparedSource(session, start_round))
    on_committed = getattr(src, "on_committed", None)
    on_dispatched = getattr(src, "on_dispatched", None)
    phase_hist = {ph: reg.histogram(f"runner_phase_{ph}_ms") for ph in obreg.RUNNER_PHASES}
    # the server's idle time: from a drain's end to the next dispatch
    idle_hist, idle_gauge = reg.histogram("runner_idle_ms"), reg.gauge("server_idle_ms")
    idle_since: float | None = None  # the end of the last drain, until a dispatch
    idle_ms: list = []

    pending: collections.deque = collections.deque()  # in-flight dispatches
    pending_rounds = 0
    totals: collections.defaultdict = collections.defaultdict(float)
    last_m: dict | None = None
    nonfinite_total = 0
    timer = Timer()
    window_t0: float | None = None  # start of the open drain window
    first_drain = True

    def drain(watch: bool = True):
        """Commit every pending dispatch: one device-to-host copy of all
        their metrics, then in-order publication and metric folding. The
        window's per-round time feeds the next in-flight depth, except the
        first, which carries cuDNN's start-up."""
        nonlocal pending_rounds, last_m, nonfinite_total, eff_inflight, ema_round_ms
        nonlocal window_t0, first_drain, idle_since
        if not pending:
            return
        committed = pending_rounds
        first = session.round  # the oldest uncommitted round
        t_d0 = time.perf_counter()
        # the drain waits out every queued round, so the watchdog's
        # threshold scales by the round count and the time it records is
        # per round
        with (watchdog.round(first, rounds=committed)
              if watch else contextlib.nullcontext()):
            with tracer.span("runner", "drain", round_first=first, rounds=committed):
                hosts = session.fetch_metrics(list(pending))
        t_c0 = time.perf_counter()
        phase_hist["drain"].observe((t_c0 - t_d0) * 1e3)
        # the deferred device spans: the dispatches' rounds are known done here
        device_spans.drained()
        with tracer.span("runner", "commit", round_first=first, rounds=committed):
            for i, m in enumerate(session.commit_rounds(list(pending), hosts)):
                last_m = m
                nonfinite_total += int(m.get("nonfinite_rounds", 0))
                stats.clients_dropped += int(m.get("clients_dropped", 0))
                quarantined = int(m.get("clients_quarantined", 0))
                stats.clients_quarantined += quarantined
                reg.counter("cohort_clients_quarantined_total").inc(quarantined)
                tracer.instant("runner", "commit_round", round=first + i)
                if quarantined:
                    tracer.instant("resilience", "quarantine", round=first + i,
                                   clients=quarantined)
                for k, v in m.items():
                    if isinstance(v, (int, float)):
                        totals[k] += v
        device_spans.flush()
        pending.clear()
        pending_rounds = 0
        stats.drains += 1
        now = time.perf_counter()
        phase_hist["commit"].observe((now - t_c0) * 1e3)
        if profile is not None:
            profile.on_committed(session.round)
        if on_committed is not None:
            on_committed(session.round)
        stats.drain_ms += (now - t_d0) * 1e3
        idle_since = time.perf_counter()
        per_round = (now - window_t0) * 1e3 / max(committed, 1)
        window_t0 = None
        stats.round_ms.append(per_round)
        stats.window_rounds.append(committed)
        if first_drain:
            first_drain = False
        else:
            ema_round_ms = (per_round if ema_round_ms <= 0
                            else 0.5 * ema_round_ms + 0.5 * per_round)
            if async_mode and cfg.max_inflight <= 0:
                eff_inflight = auto_inflight(rtt_ms, ema_round_ms)

    def take(rnd: int, n: int) -> list:
        """The next n prepared rounds, from round ``rnd``; opens a drain
        window if none is open."""
        nonlocal window_t0
        t = time.perf_counter()
        if window_t0 is None:
            window_t0 = t
        with tracer.span("runner", "prepare", round=rnd, rounds=n):
            preps = [src.next() for _ in range(n)]
        ms = (time.perf_counter() - t) * 1e3
        stats.prepare_ms += ms
        phase_hist["prepare"].observe(ms)
        return preps

    def dispatch(fn, rnd: int, n: int):
        """Launch one dispatch of n rounds from ``rnd`` (``fn`` returns its
        InFlightRound) and queue it; the sync loop drains it at once."""
        nonlocal pending_rounds, idle_since
        t_d0 = time.perf_counter()
        if idle_since is not None:
            gap = (t_d0 - idle_since) * 1e3
            idle_since = None
            idle_hist.observe(gap)
            idle_gauge.set(gap)
            idle_ms.append(gap)
        t_mark = tracer.now_us()
        start = device_spans.event()
        with tracer.span("runner", "dispatch", round=rnd, rounds=n):
            infl = fn()
        # marked only after the dispatch returned: a raising dispatch must
        # not leave a mark the next drain would close into a phantom span
        device_spans.dispatched(t_mark, rnd, n, start)
        pending.append(infl)
        if on_dispatched is not None:
            on_dispatched(rnd + n - 1)
        ms = (time.perf_counter() - t_d0) * 1e3
        stats.dispatch_ms += ms
        phase_hist["dispatch"].observe(ms)
        if len(pending) > 1:
            pending[-2].release_state()  # superseded head
        pending_rounds += n
        if cfg.sync_loop:
            drain(watch=False)

    def shutdown():
        """Exit-path teardown: stop the prefetcher and drain the writer. A
        failed async save is reported but must not block the synchronous
        exit save that follows, which is the corrective action."""
        src.stop()
        if writer is not None:
            try:
                writer.drain()
            except Exception as e:  # noqa: BLE001 — the exit save still runs
                print(f"runner: async checkpoint failure at shutdown ({type(e).__name__}: "
                      f"{e}); continuing to the synchronous exit save",
                      file=sys.stderr, flush=True)
            writer.close()

    def exit_saving(code, message: str | None = None, reason: str | None = None):
        shutdown()
        device_spans.flush(wait=True)
        path = save_ckpt() if save_ckpt else None
        if ranks > 1:
            # every rank reaches this exit at the same agreed round; none
            # leaves before rank 0's checkpoint is written, so a run resumed
            # at once (a relaunch, or the same processes calling main again)
            # finds it on every rank
            distributed.all_hosts_max(0)
        if message:
            # in a group of ranks rank 0 alone writes
            print(message.format(path=path if path or ranks == 1 else "written by rank 0"),
                  flush=True)
        if reason:
            _postmortem(reason)
        sys.exit(code)

    rnd = start_round
    try:
        with PreemptionHandler() as pre:
            while rnd < cfg.total_rounds:
                lrs = plan_block(opt, rnd, cfg.total_rounds, eval_every,
                                 cfg.checkpoint_every, cfg.rounds_per_dispatch)
                if len(lrs) > 1 and session.supports_block_dispatch:
                    # a block cannot split, so the capture window opens on
                    # overlap (a round-aligned superset)
                    if profile is not None:
                        profile.on_dispatch(rnd, rounds=len(lrs))
                    # one dispatch for the block; the watchdog times it with
                    # the prefetch pull (a stalled loader is a stall)
                    with watchdog.round(rnd, record=cfg.sync_loop):
                        preps = take(rnd, len(lrs))
                        dispatch(lambda: session.dispatch_block(preps, lrs), rnd, len(lrs))
                    rnd += len(lrs)
                else:
                    for lr in lrs:
                        if profile is not None:
                            profile.on_dispatch(rnd)
                        with watchdog.round(rnd, record=cfg.sync_loop):
                            prep = take(rnd, 1)[0]
                            dispatch(lambda: session.dispatch_round(prep, lr), rnd, 1)
                        rnd += 1
                        if pre.triggered and ranks == 1:
                            break  # stop inside the block: the grace window is short
                preempt_now = preemption.coordinated(pre.triggered)
                if pending_rounds and (preempt_now or pending_rounds >= eff_inflight
                                       or rnd >= cfg.total_rounds or rnd % eval_every == 0
                                       or (cfg.checkpoint_every
                                           and rnd % cfg.checkpoint_every == 0)):
                    drain()
                if preempt_now:
                    tracer.instant("resilience", "preempt_boundary", round=session.round)
                    exit_saving(EXIT_RESUMABLE,
                                f"preemption: emergency checkpoint at round {session.round}: "
                                "{path}", reason="preemption")
                saved = ("state checkpointed clean)" if save_ckpt
                         else "no --checkpoint_dir, nothing saved)")
                if nonfinite_total and cfg.on_nonfinite == "halt":
                    exit_saving(f"halting at round {rnd}: non-finite update skipped "
                                "(--on_nonfinite halt; " + saved)
                if slo is not None and slo.halted:
                    # the session fed the engine at the drain above; a latched
                    # halt exits through the non-finite halt's clean sequence
                    exit_saving(f"halting at round {rnd}: SLO violation ({slo.halted_reason}) "
                                "(--slo halt; " + saved)
                if cfg.checkpoint_every and save_ckpt and rnd % cfg.checkpoint_every == 0:
                    if writer is not None:
                        writer.request()  # off the round path
                        stats.async_checkpoints += 1
                    else:
                        with tracer.span("runner", "checkpoint_sync", round=session.round):
                            save_ckpt()
                        stats.sync_checkpoints += 1
                if rnd % eval_every == 0 or rnd >= cfg.total_rounds:
                    with tracer.span("runner", "eval", round=session.round):
                        ev = eval_fn() if eval_fn is not None else {}
                    stats.evals += 1
                    if build_row is not None and logger is not None:
                        logger.append(build_row(rnd=rnd, m=last_m, totals=dict(totals), ev=ev,
                                                time_s=timer(),
                                                nonfinite_total=nonfinite_total))
                    totals.clear()
    finally:
        if profile is not None:
            profile.close()
        src.stop()
        # the prefetcher may have drawn host RNG, and served or grown the
        # dropped-client queue, for rounds never dispatched: rewind both
        # (the queue with its ages) to the committed boundary so a caller
        # reusing the session stays on the sync loop's sequence
        with session.mutate_lock:
            session.rng.set_state(session.rng_snapshot)
            session._requeue = collections.deque(session._requeue_committed)
            session._requeue_enqueued = dict(session._requeue_ages_committed)
    # a stored async-save failure must not block the final save below,
    # the corrective action (with its own retries)
    shutdown()
    device_spans.flush(wait=True)
    if save_ckpt:
        save_ckpt()  # final checkpoint, synchronous: durable before return
        stats.sync_checkpoints += 1
    stats.rounds = session.round - start_round
    stats.nonfinite_rounds = nonfinite_total
    stats.slo_violations = int(mark.delta("slo_violations_total"))
    stats.attacks_injected = sum(int(mark.delta(f"resilience_attack_{k[len('client_'):]}_total"))
                                 for k in ADVERSARIAL_KINDS)
    stats.max_inflight_used = eff_inflight if async_mode else 0
    stats.server_idle_ms = sum(idle_ms) / max(len(idle_ms), 1)
    stats.server_idle_ms_max = max(idle_ms, default=0.0)
    stats.wall_s = time.perf_counter() - t0
    session.run_stats = stats
    return stats
