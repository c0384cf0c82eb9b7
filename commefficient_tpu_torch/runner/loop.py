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

``--sync_loop`` is the serial path: inline preparation, one
prepare -> dispatch -> drain per round (or block), blocking saves. Both
paths run the same step in the same order on the same host RNG stream,
which is why the tests pin them bitwise equal.

Observability (``obs/``): the loop's phases are spans on the tracer's
``runner`` track (prepare, dispatch, drain, commit, checkpoint_sync, eval),
with a ``commit_round`` instant per committed round. Each dispatch records
only a host timestamp; the drain that commits it closes a deferred
``device`` span from that timestamp to the drain's, so tracing adds no host
sync. ``--profile_rounds`` opens a ``torch.profiler`` window
(``obs.profiler.ProfileWindow``) at the dispatch of its first round and
closes it after the drain that commits its last. An SLO engine in ``halt``
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
from ..resilience import EXIT_RESUMABLE, PreemptionHandler
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
    # degraded load), summed over the run, and the deepest the
    # dropped-client queue ran at a round's preparation
    clients_dropped: int = 0
    requeue_depth_max: int = 0
    # SLO engine firings while this loop ran (the slo_violations_total
    # registry counter's delta over the run)
    slo_violations: int = 0


def make_save_ckpt(session: FederatedSession, checkpoint_dir: str, timings: list | None = None):
    """The one save closure of a run: serialised by its own lock (the
    watchdog's emergency save runs on a timer thread and must not race a
    periodic save of the same round), sharing the session's fault plan and
    retry policy. Each save's timings are appended to ``timings``."""
    lock = threading.Lock()

    def save_ckpt():
        t: dict = {}
        with lock:
            path = ckpt.save(checkpoint_dir, session, fault_plan=session.fault_plan,
                             retry_policy=session.retry_policy, timings=t)
        if timings is not None:
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
    round order, ``stop()``; an optional ``on_committed(round)`` hook):
    the serving layer's ``ServedSource``,
    which makes the service, not the sampling prefetcher, the producer of
    rounds. Its preparation then runs on this (the dispatch) thread.

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
    if save_ckpt is None and cfg.checkpoint_dir:
        save_ckpt = make_save_ckpt(session, cfg.checkpoint_dir, stats.checkpoints)
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

    # escalation ladder: warn -> stacks -> emergency checkpoint -> (opt-in)
    # abort with the resumable status
    watchdog = RoundWatchdog(
        on_emergency=save_ckpt if save_ckpt and not cfg.no_emergency_checkpoint else None,
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
              if async_mode and save_ckpt and cfg.checkpoint_every else None)
    src = source if source is not None else (
        RoundPrefetcher(session, start_round, depth=prefetch_depth) if async_mode
        else PreparedSource(session, start_round))
    on_committed = getattr(src, "on_committed", None)
    phase_hist = {ph: reg.histogram(f"runner_phase_{ph}_ms") for ph in obreg.RUNNER_PHASES}

    pending: collections.deque = collections.deque()  # in-flight dispatches
    pending_rounds = 0
    # per dispatch (trace timestamp, first round, round count): the deferred
    # device spans, closed by the drain that commits them
    dispatch_marks: collections.deque = collections.deque()
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
        nonlocal window_t0, first_drain
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
        # the deferred device spans: each dispatch recorded a host timestamp;
        # its rounds are known done here
        end_us = tracer.now_us()
        while dispatch_marks:
            ts_us, d_first, d_n = dispatch_marks.popleft()
            tracer.complete("device", f"rounds {d_first}..{d_first + d_n - 1}", ts_us,
                            end_us - ts_us, round_first=d_first, rounds=d_n, sketch_path="ravel")
        with tracer.span("runner", "commit", round_first=first, rounds=committed):
            for i, m in enumerate(session.commit_rounds(list(pending), hosts)):
                last_m = m
                nonfinite_total += int(m.get("nonfinite_rounds", 0))
                stats.clients_dropped += int(m.get("clients_dropped", 0))
                stats.requeue_depth_max = max(stats.requeue_depth_max,
                                              int(m.get("requeue_depth", 0)))
                tracer.instant("runner", "commit_round", round=first + i)
                for k, v in m.items():
                    if isinstance(v, (int, float)):
                        totals[k] += v
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
        nonlocal pending_rounds
        t_d0 = time.perf_counter()
        t_mark = tracer.now_us()
        with tracer.span("runner", "dispatch", round=rnd, rounds=n):
            infl = fn()
        # marked only after the dispatch returned: a raising dispatch must
        # not leave a mark the next drain would close into a phantom span
        dispatch_marks.append((t_mark, rnd, n))
        pending.append(infl)
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
        path = save_ckpt() if save_ckpt else None
        if message:
            print(message.format(path=path), flush=True)
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
                        if pre.triggered:
                            break  # stop inside the block: the grace window is short
                if pending_rounds and (pre.triggered or pending_rounds >= eff_inflight
                                       or rnd >= cfg.total_rounds or rnd % eval_every == 0
                                       or (cfg.checkpoint_every
                                           and rnd % cfg.checkpoint_every == 0)):
                    drain()
                if pre.triggered:
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
    if save_ckpt:
        save_ckpt()  # final checkpoint, synchronous: durable before return
        stats.sync_checkpoints += 1
    stats.rounds = session.round - start_round
    stats.nonfinite_rounds = nonfinite_total
    stats.slo_violations = int(mark.delta("slo_violations_total"))
    stats.max_inflight_used = eff_inflight if async_mode else 0
    stats.wall_s = time.perf_counter() - t0
    session.run_stats = stats
    return stats
