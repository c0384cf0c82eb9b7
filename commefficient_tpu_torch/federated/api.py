"""The user-facing federated session: the PyTorch twin of the JAX package's
``federated/api.py`` for the single-device round.

``FederatedSession`` owns the server state (flat params, batch-norm
statistics, Vvelocity/Verror), the client state (local_topk's
[num_clients, d] local error and momentum, when the mode keeps any), the
host sampling stream and the communication accounting. A round runs in
three steps, so the run loop (``runner/``) can overlap them:

- ``prepare_round``: sample the cohort (queued clients that were dropped
  earlier take the place of sampled ones), assemble its batch on the host
  with the round's fault sites (pinned host tensors when the session runs
  on the GPU); any thread, one at a time, in round order. A load that
  still fails after its retries degrades the round to a fully masked
  cohort, whose clients are queued.
- ``dispatch_round`` / ``dispatch_block``: copy the batch to the device
  without a host sync and launch the round's work, chained on the newest
  dispatched state; returns device metrics. A round of a mode with client
  state gathers the cohort's rows before its step and scatters the new
  rows after it, out of place: a new [num_clients, d] tensor per key, so a
  committed client state is never written again (checkpoints copy it while
  later rounds run).
- ``commit_rounds``: publish state, client state, round counter,
  communication totals and the host-RNG and requeue snapshots, in dispatch
  order, under ``mutate_lock``.

A served round (``serve/``) prepares from an arrival stream instead:
``sample_cohort`` gives the invite list, ``prepare_served_round`` masks and
queues the invitees that missed the close exactly as ``client_drop``
faults. A ``wire_payloads`` session (``--serve_payload sketch``) runs the
payload round: ``compute_client_tables`` (the per-client tables, copied to
the host once), the wire, ``finish_served_payload``, then
``dispatch_round`` merges the validated stack; its batch round composes
the same two steps (``engine.compose_payload``). A robust ``merge_policy``
and a fault plan that names an adversarial kind run that round too, and
such a plan's ``_adv_*`` keys ride every round's batch (the identity off
schedule). With ``client_update_clip`` the server state carries the
quarantine's rings; ``quarantine_median_host`` is what the serving
gauntlet screens against, and ``clients_quarantined_total`` counts the
rejected clients, who stay charged for their uplink.

Observability (``obs/``): preparation is a ``federated`` span with
``cohort_degraded`` and ``requeue_serve`` instants; with ``health_every``
N > 0 each round's batch carries the host cadence flag
(``engine.HEALTH_KEY``, armed on rounds ``rnd % N == 0``), and with
``ledger_fingerprint`` every round's metrics carry the state fingerprints.
``commit_rounds`` pops the "health/" and "ledger/" metrics before any row
or total sees them and hands each committed round to the attached sinks
(``health_monitor``, ``slo``, ``ledger``) in ``_publish_round_obs``.

``FedModel`` and ``FedOptimizer`` mirror the reference's
``FedModel(model, loss_fn, args)`` / ``FedOptimizer(opt, args)`` surface.
The session runs on the GPU unless ``device="cpu"`` is passed. Batches are
dicts of host arrays with leading axis W, images (float32, with labels and
a mask) or token rows (int32 ``input_ids``, ``token_type_ids``,
``labels``); a model without batch norm has an empty ``net_state``.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..data.fed_dataset import FedDataset
from ..models.convert import FlatLayout
from ..modes import modes
from ..modes.config import ModeConfig
from ..obs import trace as obtrace
from ..resilience import retry as rtry
from ..utils.comm import BYTES_F32, BYTES_PAIR, round_comm_mb
from ..utils.device import resolve_device
from . import engine


@dataclasses.dataclass(frozen=True)
class PreparedRound:
    """Host half of a round: the cohort, its assembled batch (host tensors
    with leading axis W plus ``engine.VALID_KEY``; pinned when the session
    runs on the GPU, so the copy to the card needs no host sync) and
    ``snapshot``, the host RNG state right after this round's draws.
    Committing the round publishes the snapshot as the session's
    round-boundary state, so a checkpoint stays replay-consistent while a
    prefetcher has already advanced the live stream. ``masked`` counts the
    clients the validity mask killed (dropped, or a degraded load);
    ``requeue`` and ``requeue_ages`` ((client id, round queued) pairs) are
    the dropped-client queue as of this preparation, published at commit
    like the snapshot. ``payload`` is a served payload round's
    (validated [W, r, c] host table stack, [W] arrival mask, the client
    step's device leftovers) for ``dispatch_round``'s merge; None
    otherwise. ``health_on`` mirrors the batch's health cadence flag, so
    commit knows which rounds' health blocks are real without reading a
    device value."""

    rnd: int
    ids: np.ndarray
    batch: dict
    snapshot: tuple
    masked: int = 0
    requeue: tuple = ()
    requeue_ages: tuple = ()
    payload: tuple | None = None
    health_on: bool = False


@dataclasses.dataclass
class InFlightRound:
    """A dispatched, uncommitted round or block of rounds, with the server
    state and client state (None when the mode keeps none) it produced.
    ``metrics`` stay device tensors until the run loop drains them.
    ``done`` is the CUDA event recorded after the dispatch (None on the
    CPU): a checkpoint of this state waits for it alone. ``host_batch`` keeps the pinned source of
    the non-blocking copy referenced until commit. ``masked`` and
    ``requeue_depths`` hold each round's counts (aligned with ``lrs``),
    ``requeue``/``requeue_ages`` the newest preparation's queue;
    ``cohorts`` and ``health_on`` each round's invited ids and cadence flag
    (what commit hands the obs sinks)."""

    new_state: dict | None
    new_client_state: dict | None
    metrics: dict
    lrs: list
    snapshot: tuple
    stacked: bool  # block dispatch: every metric has a leading [K] axis
    done: Any = None
    host_batch: dict | None = None
    masked: list = dataclasses.field(default_factory=list)
    requeue_depths: list = dataclasses.field(default_factory=list)
    requeue: tuple = ()
    requeue_ages: tuple = ()
    cohorts: list = dataclasses.field(default_factory=list)
    health_on: list = dataclasses.field(default_factory=list)

    @property
    def num_rounds(self) -> int:
        return len(self.lrs)

    def release_state(self):
        """Drop the state references. The run loop calls this when a newer
        dispatch supersedes this one: only the newest pending state is
        published at a batch commit, and a superseded client state (5.3 GB
        for ResNet-9 local_topk at 100 clients) is freed."""
        self.new_state = None
        self.new_client_state = None


class FederatedSession:
    def __init__(
        self,
        train_loss_fn: Callable,
        eval_loss_fn: Callable,
        params: dict,
        net_state: dict,
        layout: FlatLayout,
        mode_cfg: ModeConfig,
        train_set: FedDataset,
        num_workers: int,
        local_batch_size: int,
        weight_decay: float = 0.0,
        seed: int = 0,
        on_nonfinite: str = "off",
        fault_plan=None,
        retry_policy: rtry.RetryPolicy | None = None,
        device: str | torch.device = "cuda",
        client_dropout: float = 0.0,
        dp_clip: float = 0.0,
        dp_noise: float = 0.0,
        requeue_policy: str = "fifo",
        wire_payloads: bool = False,
        client_chunk: int = 0,
        health_every: int = 0,
        ledger_fingerprint: bool = False,
        client_update_clip: float = 0.0,
        quarantine_window: int = 1,
        merge_policy: str = "sum",
        merge_trim: int = 0,
        quarantine_scope: str = "cohort",
        robust_residual: bool = False,
    ):
        self.device = resolve_device(device)
        if health_every < 0:
            raise ValueError(f"health_every must be >= 0, got {health_every}")
        if layout.d != mode_cfg.d:
            raise ValueError(f"mode_cfg.d={mode_cfg.d} but the model has d={layout.d}")
        if on_nonfinite not in ("off", "skip", "halt"):
            raise ValueError(f"on_nonfinite must be 'off', 'skip' or 'halt', got "
                             f"{on_nonfinite!r}")
        if requeue_policy not in ("fifo", "aged"):
            raise ValueError(f"requeue_policy must be 'fifo' or 'aged', got {requeue_policy!r}")
        self.train_set = train_set
        self.num_workers = min(num_workers, train_set.num_clients)
        self.local_batch_size = local_batch_size
        # "halt" is the run loop's policy on top of the step's "skip"
        self.cfg = engine.EngineConfig(
            mode=mode_cfg, weight_decay=weight_decay,
            on_nonfinite="skip" if on_nonfinite == "halt" else on_nonfinite, seed=seed,
            client_dropout=client_dropout, dp_clip=dp_clip, dp_noise=dp_noise,
            wire_payloads=wire_payloads, client_chunk=client_chunk,
            # in-step observability (--health_every N > 0, --ledger): both
            # only read round state, so armed rounds are bitwise unarmed ones
            health=health_every > 0, ledger_fingerprint=ledger_fingerprint,
            # the sketch-space quarantine (its baseline window and scope) and
            # the Byzantine-robust table merge (see EngineConfig)
            client_update_clip=client_update_clip, quarantine_window=quarantine_window,
            merge_policy=merge_policy, merge_trim=merge_trim,
            quarantine_scope=quarantine_scope, robust_residual=robust_residual)
        self._health_every = max(health_every, 1)
        # the per-client-table round serves a real wire (wire_payloads), a
        # robust merge (order statistics need each client's table) and the
        # adversarial fault kinds (they transform the per-client wire, which
        # exists only there)
        adv = fault_plan is not None and fault_plan.has_adversarial()
        if fault_plan is not None and fault_plan.has_normride() and client_update_clip <= 0:
            raise ValueError("client_normride rides just under the quarantine screen (scale to "
                             "ride * clip * running median); with --client_update_clip at 0 "
                             "there is no threshold to ride and the attack is undefined - arm "
                             "the quarantine")
        self._table_round = engine.uses_table_round(self.cfg) or adv
        if self._table_round and mode_cfg.mode != "sketch":
            why = (f"merge_policy={merge_policy!r}" if engine.robust_policy(self.cfg)
                   else "adversarial fault kinds (client_signflip/client_scale/client_collude/"
                        "client_normride)")
            raise ValueError(f"{why} need(s) the per-client-table round, which requires "
                             f"mode='sketch'; got mode={mode_cfg.mode!r}")
        # the obs sinks commit hands each round to (obs.attach_from_args
        # sets them): the health monitor, the SLO engine, the round ledger
        self.health_monitor = None
        self.slo = None
        self.ledger = None
        if client_chunk and self.num_workers % client_chunk:
            # the cohort may have been clamped to num_clients: a chunk that
            # divided the requested cohort may no longer divide. Largest
            # viable chunk, as the reference repairs it
            viable = next(c for c in range(min(client_chunk, self.num_workers), 0, -1)
                          if self.num_workers % c == 0)
            print(f"note: client_chunk={client_chunk} does not divide the cohort "
                  f"({self.num_workers}); using client_chunk={viable}", flush=True)
            self.cfg = dataclasses.replace(self.cfg, client_chunk=viable)
        self.layout = layout
        self.train_loss_fn = train_loss_fn
        self._build_steps()
        pflat = layout.flatten({k: v.detach().to(self.device) for k, v in params.items()})
        self.state = engine.init_server_state(
            self.cfg, pflat, {k: v.detach().to(self.device).clone() for k, v in net_state.items()},
            layout)
        # [num_clients, d] per key, or None
        self.client_state = modes.init_client_state(mode_cfg, train_set.num_clients,
                                                    self.device)
        self._eval = engine.make_eval_step(eval_loss_fn, layout)
        self.fault_plan = fault_plan
        self.retry_policy = retry_policy or rtry.RetryPolicy()
        self.rng = np.random.RandomState(seed)
        self._snapshot_rng()
        self._seed = seed
        # the dropped-client queue: ids whose batch was dropped or failed to
        # load wait here and take the place of sampled ids in a later
        # round, so their data is delayed, not lost. _requeue is the live
        # queue (one producer: prepare_round), _requeue_enqueued maps a
        # queued id to the round it was queued (the aged policy's weights),
        # and the *_committed pair is the round-boundary snapshot that
        # checkpoints write (a prefetcher may have served the live queue for
        # rounds that never commit). Serving order: "fifo", or "aged" (a
        # weighted draw by rounds waiting from a RandomState of its own).
        self._requeue_policy = requeue_policy
        self._requeue: collections.deque = collections.deque()
        self._requeue_enqueued: dict[int, int] = {}
        self._requeue_committed: tuple = ()
        self._requeue_ages_committed: tuple = ()
        # guards the publication of (state, round, RNG snapshot, comm
        # totals) against a checkpoint taken from another thread (the
        # watchdog's emergency save, the async writer)
        self.mutate_lock = threading.Lock()
        # the CUDA event after which the committed state is complete
        self.committed_event = None
        # pipelining head: the newest dispatched state, distinct from
        # self.state (the newest committed one). _inflight counts dispatch
        # units (a block is one), _inflight_rounds counts rounds. Main
        # thread only.
        self._inflight = 0
        self._inflight_rounds = 0
        self._head_state = None
        self._head_client_state = None
        self._copy_stream = None
        self.round = 0
        self.comm_per_round = round_comm_mb(mode_cfg, self.num_workers)
        self.comm_mb_total = 0.0
        # clients the quarantine rejected, summed over committed rounds (the
        # service's status reads it)
        self.clients_quarantined_total = 0
        self.run_stats = None  # the RunStats of the last run_loop that finished
        # the serving layer's checkpoint hook (a callable returning the
        # meta.json "serve" block, set by serve.AggregationService) and the
        # block a restore read back for a service to pick up
        self.serve_meta = None
        self.restored_serve_meta = None
        # a served payload round's copies of the [W, r, c] table stack:
        # (direction, bytes, start event, end event) not read yet, and the
        # totals of the read ones, by direction (wire_copy_stats)
        self._wire_copies: list = []
        self._wire_totals: dict = {}

    def _build_steps(self) -> None:
        """The round steps of ``self.cfg`` (again after a restore changes
        ``client_chunk``)."""
        loss_fn, cfg, layout = self.train_loss_fn, self.cfg, self.layout
        self._payload_client = self._payload_merge = None
        if self._table_round:
            # the per-client-table round (--serve_payload sketch, a robust
            # --merge_policy, adversarial fault kinds): per-client tables,
            # then the table merge. The batch round composes the two; a
            # served round runs them apart with the wire between
            # (compute_client_tables, then dispatch_round of a payload
            # preparation)
            self._payload_client, self._payload_merge = engine.make_payload_round_steps(
                loss_fn, cfg, layout)
            self._step = engine.compose_payload(self._payload_client, self._payload_merge)
            self._multi = None
        else:
            self._step = engine.make_round_step(loss_fn, cfg, layout)
            self._multi = (None if cfg.mode.needs_local_state
                           else engine.make_multi_round_step(loss_fn, cfg, layout))

    def set_client_chunk(self, chunk: int) -> None:
        """Run later rounds at ``client_chunk`` = ``chunk`` (a restore sets
        the checkpoint's, so a resumed run sums its clients as the run it
        resumes did)."""
        if chunk != self.cfg.client_chunk:
            self.cfg = dataclasses.replace(self.cfg, client_chunk=chunk)
            self._build_steps()

    @property
    def inflight_rounds(self) -> int:
        return self._inflight_rounds

    def copy_stream(self) -> torch.cuda.Stream:
        """The CUDA stream checkpoints copy the committed state on."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        return self._copy_stream

    def _snapshot_rng(self):
        """Capture the host sampling RNG as of the last committed round. The
        device draws only dropout masks, from generators seeded by the round
        index (``engine.dropout_seed``), so the host RandomState is the whole
        RNG state of a round boundary."""
        self.rng_snapshot = self.rng.get_state()

    def _host(self, a: np.ndarray) -> torch.Tensor:
        """A host tensor of ``a``, pinned when the session runs on the GPU."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, batch: dict) -> dict:
        """Copy a batch of host tensors (or numpy arrays) to the session's
        device. From pinned memory the copy is queued without a host sync.
        The health cadence flag stays on the host, where the step reads it."""
        return {k: v if k == engine.HEALTH_KEY else
                (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v)))
                .to(self.device, non_blocking=True) for k, v in batch.items()}

    def _record(self, timing: bool = False):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record()
        return ev

    def sample_cohort(self, rnd: int) -> np.ndarray:
        """Draw the round's cohort from the host sampling stream and put
        queued (earlier dropped) clients in. The substitution draws nothing
        from the stream, so only the cohort's membership changes."""
        ids = self.train_set.sample_clients(self.rng, self.num_workers)
        if self._requeue:
            ids = self._serve_requeue(ids, rnd)
        return ids

    def _serve_requeue(self, ids: np.ndarray, rnd: int) -> np.ndarray:
        """Substitute queued client ids into a sampled cohort in
        ``requeue_policy`` order, from slot 0 on, skipping ids the sample
        already holds (they count as served). What finds no slot stays
        queued."""
        ids = np.array(ids, copy=True)
        in_cohort = {int(i) for i in ids}
        order = list(self._requeue)
        if self._requeue_policy == "aged" and len(order) > 1:
            order = self._aged_order(order, rnd)
        slot, served, leftover = 0, [], []
        for cid in order:
            if slot >= len(ids):
                leftover.append(cid)
                continue
            if cid in in_cohort:
                self._requeue_enqueued.pop(cid, None)
                continue
            in_cohort.discard(int(ids[slot]))
            ids[slot] = cid
            in_cohort.add(cid)
            served.append(cid)
            self._requeue_enqueued.pop(cid, None)
            slot += 1
        self._requeue = collections.deque(leftover)
        if served:
            obtrace.instant("federated", "requeue_serve", round=rnd,
                            clients=[int(c) for c in served], still_queued=len(self._requeue))
            print(f"requeue: serving previously-dropped client(s) {served} "
                  f"({len(self._requeue)} still queued)", file=sys.stderr, flush=True)
        return ids

    def _aged_order(self, queue: list, rnd: int) -> list:
        """requeue_policy="aged": Efraimidis-Spirakis weighted sampling
        without replacement, weight = rounds waiting + 1, from a RandomState
        of its own pinned to (seed, round), so the host sampling stream is
        the same under either policy."""
        rs = np.random.RandomState((self._seed * 1_000_003 + rnd) % (2**32))
        ages = np.array([rnd - self._requeue_enqueued.get(int(c), rnd) + 1 for c in queue],
                        np.float64)
        keys = rs.random_sample(len(queue)) ** (1.0 / ages)
        return [queue[i] for i in np.argsort(-keys, kind="stable")]

    def _queue(self, cid: int, rnd: int):
        """Queue a dropped client once: overlapping drop specs can name the
        same position twice, and a doubly queued id would displace two
        sampled clients later."""
        if cid not in self._requeue:
            self._requeue.append(cid)
            self._requeue_enqueued.setdefault(cid, rnd)

    def _with_local_axis(self, batch: dict) -> dict:
        mcfg = self.cfg.mode
        if mcfg.uses_weight_delta and mcfg.num_local_iters == 1:
            # the sampler drops the [L] axis at L = 1; the local-SGD loop
            # reads microbatches off it
            return {k: v[:, None] for k, v in batch.items()}
        return batch

    def _load_client_batch(self, ids: np.ndarray, rnd: int):
        """Batch assembly behind the retry wrapper; returns (batch, valid or
        None). The fault site fires before any host RNG is drawn and a
        failed attempt restores the RNG, so a retried load replays the
        identical batch. A load that still fails after the retries degrades
        the round instead of ending the run: an ``empty_batch`` behind an
        all-zero validity mask (the engine's fully masked cohort: momentum
        decays, state stays as it was), its clients queued for later
        rounds, and a line on stderr. Such a round draws no batch RNG."""
        mcfg = self.cfg.mode

        def attempt():
            rng_state = self.rng.get_state()
            try:
                if self.fault_plan is not None:
                    self.fault_plan.data_load(rnd)
                return self.train_set.client_batch(self.rng, ids, self.local_batch_size,
                                                   mcfg.num_local_iters)
            except Exception:
                self.rng.set_state(rng_state)
                raise

        try:
            batch = rtry.with_retries(attempt, site="data_load", policy=self.retry_policy,
                                      seed=rnd)
            return self._with_local_axis(batch), None
        except Exception as e:  # noqa: BLE001 — degrade the round, do not end the run
            print(f"ERROR: round {rnd} batch load failed after retries ({type(e).__name__}: "
                  f"{e}); degrading to a fully-masked cohort and re-queuing its {len(ids)} "
                  "client(s)", file=sys.stderr, flush=True)
            for i in ids:
                self._queue(int(i), rnd)
            batch = self.train_set.empty_batch(len(ids), self.local_batch_size,
                                               mcfg.num_local_iters)
            return self._with_local_axis(batch), np.zeros(len(ids), np.float32)

    def prepare_round(self, rnd: int | None = None) -> PreparedRound:
        """Host half of a round: sample the cohort, assemble the batch (fault
        sites at ``rnd``), pin it. Draws from the live host stream in round
        order: one producer at a time, sequentially."""
        if rnd is None:
            rnd = self.round + self._inflight_rounds
        return self._assemble_round(rnd, self.sample_cohort(rnd))

    def prepare_served_round(self, rnd: int, ids: np.ndarray, arrived) -> PreparedRound:
        """Round preparation from an arrival stream (``serve/``): ``ids`` is
        what ``sample_cohort(rnd)`` returned (the invite list) and
        ``arrived`` the [W] 0/1 mask of invitees that made the close. A
        no-show or straggler is handled exactly as a ``client_drop`` fault
        (rows zeroed, validity 0, client queued), so a served short cohort
        is bitwise the batch round that drops the same positions."""
        arrived = np.asarray(arrived, np.float32)
        if len(arrived) != len(ids):
            raise ValueError(f"arrival mask covers {len(arrived)} clients but the round "
                             f"invited {len(ids)}")
        return self._assemble_round(rnd, ids, arrived)

    def _assemble_round(self, rnd: int, ids: np.ndarray, arrived=None) -> PreparedRound:
        """Batch assembly (fault sites at ``rnd``), the served round's
        no-show masking, the validity mask and the health flag, on the
        ``federated`` track (on the prefetch thread in async mode, so a
        trace shows it beside device work)."""
        with obtrace.span("federated", "prepare_round", round=rnd, cohort=len(ids)):
            return self._assemble_round_traced(rnd, ids, arrived)

    def _assemble_round_traced(self, rnd: int, ids: np.ndarray, arrived=None) -> PreparedRound:
        batch, valid = self._load_client_batch(ids, rnd)
        if self.fault_plan is not None:
            # the nonfinite burst, then the cohort faults; preempt stays a
            # dispatch-time site, so the SIGTERM lands when the round runs
            batch = self.fault_plan.poison(rnd, batch)
            batch, valid, dropped = self.fault_plan.client_faults(rnd, batch, valid, len(ids))
            for p in dropped:
                self._queue(int(ids[p]), rnd)
        if arrived is not None and (arrived == 0.0).any():
            # a served round closed short: its casualties get the
            # client_drop treatment at the point the fault site uses
            no_show = [int(p) for p in np.flatnonzero(arrived == 0.0)]
            valid = (np.ones(len(ids), np.float32) if valid is None
                     else np.array(valid, copy=True))
            batch = {k: (v if k.startswith("_") else np.array(v, copy=True))
                     for k, v in batch.items()}
            for k, v in batch.items():
                if not k.startswith("_"):
                    v[no_show] = 0
            valid[no_show] = 0.0
            for p in no_show:
                self._queue(int(ids[p]), rnd)
        masked = int(len(ids) - valid.sum()) if valid is not None else 0
        if masked:
            obtrace.instant("federated", "cohort_degraded", round=rnd, clients=masked)
        # the validity mask always rides the batch (all ones when clean)
        batch = dict(batch)
        batch[engine.VALID_KEY] = valid if valid is not None else np.ones(len(ids), np.float32)
        if self._table_round and self.fault_plan is not None and \
                self.fault_plan.has_adversarial():
            # the adversarial wire transform rides every round of a plan
            # that names the kinds, the identity off schedule
            scale, src = self.fault_plan.adversarial_plan(rnd, len(ids))
            batch[engine.ADV_SCALE_KEY] = scale
            batch[engine.ADV_SRC_KEY] = src
            if self.fault_plan.has_normride():
                batch[engine.ADV_RIDE_KEY] = self.fault_plan.normride_plan(rnd, len(ids))
        health_on = False
        if self.cfg.health:
            # the cadence flag rides the batch like the validity mask, and
            # stays on the host (_to_device)
            health_on = rnd % self._health_every == 0
            batch[engine.HEALTH_KEY] = np.full(len(ids), 1.0 if health_on else 0.0, np.float32)
        return PreparedRound(rnd, ids, {k: self._host(v) for k, v in batch.items()},
                             self.rng.get_state(), masked=masked, requeue=tuple(self._requeue),
                             requeue_ages=tuple(self._requeue_enqueued.items()),
                             health_on=health_on)

    # -- the served payload round (serve/, --serve_payload sketch) ------

    def compute_client_tables(self, prep: PreparedRound) -> tuple[np.ndarray, tuple]:
        """Run the payload round's client step on a prepared cohort, chained
        on the newest dispatched state, and copy its [W, r, c] table stack
        into one pinned host buffer: the round's one host sync, since the
        tables are the objects that cross the wire. Returns (tables [W, r, c]
        float32 numpy, aux), ``aux`` the device leftovers the merge needs
        (the state the client step read, per-client statistics and metric
        rows, the participation mask)."""
        if self._payload_client is None:
            raise RuntimeError("compute_client_tables needs a per-client-table session "
                               "(--serve_payload sketch, a robust --merge_policy or an "
                               "adversarial fault kind)")
        state = self._head()
        tables, nstates, mvals, part, lnorms = self._payload_client(
            state, self._to_device(prep.batch))
        if self.device.type == "cuda":
            host = torch.empty(tables.shape, dtype=tables.dtype, pin_memory=True)
            t0 = self._record(timing=True)
            host.copy_(tables, non_blocking=True)
            t1 = self._record(timing=True)
            t1.synchronize()
            self._wire_copies.append(("d2h", host.numel() * host.element_size(), t0, t1))
            self._fold_wire_copies()  # the sync completed every earlier copy too
        else:
            host = tables
        return host.numpy(), (state, nstates, mvals, part, lnorms)

    def quarantine_median_host(self) -> float:
        """The current quarantine baseline on the host (0.0 with the
        quarantine off or not seeded yet): what the ingest gauntlet's
        sketch-space L2 screen reads. It is the cohort ring's median, the
        one the table merge screens the table norms against, so a payload
        the gauntlet rejects as QUARANTINED is one the merge would have
        quarantined. A payload round syncs once anyway
        (``compute_client_tables``), before this is read."""
        if self.cfg.client_update_clip <= 0:
            return 0.0
        return float(self._head()["quarantine"]["median"])

    def finish_served_payload(self, prep: PreparedRound, arrived, wire_tables,
                              aux: tuple) -> PreparedRound:
        """After a served payload round's close: every invitee whose payload
        missed the merge (no-show, straggler, rejected frame) is counted as
        masked and queued, and the preparation carries the validated table
        stack and the arrival mask for ``dispatch_round``. Draws no host
        RNG, so the preparation's RNG snapshot stays valid."""
        arrived = np.asarray(arrived, np.float32)
        valid = np.asarray(prep.batch[engine.VALID_KEY], np.float32)
        eff = valid * arrived
        for p in np.flatnonzero(eff == 0.0):
            self._queue(int(prep.ids[int(p)]), prep.rnd)
        masked = int(len(prep.ids) - eff.sum())
        if masked:
            obtrace.instant("federated", "cohort_degraded", round=prep.rnd, clients=masked)
        return dataclasses.replace(
            prep, masked=masked, requeue=tuple(self._requeue),
            requeue_ages=tuple(self._requeue_enqueued.items()),
            payload=(np.asarray(wire_tables, np.float32), arrived, aux))

    def _dispatch_payload_merge(self, prep: PreparedRound, lr: float) -> InFlightRound:
        """Dispatch the payload round's merge over the validated tables a
        served round collected: one pinned host-to-device copy of the
        [W, r, c] stack, then the merge on the state the client step read."""
        wire_tables, arrived, aux = prep.payload
        state, nstates, mvals, part, lnorms = aux
        host = self._host(wire_tables)
        t0 = self._record(timing=True)
        tables = host.to(self.device, non_blocking=True)
        if t0 is not None:
            self._wire_copies.append(("h2d", host.numel() * host.element_size(), t0,
                                      self._record(timing=True)))
        lr_host = self._host(np.asarray(lr, np.float32))
        new_state, metrics = self._payload_merge(
            state, tables, nstates, mvals, part,
            self._host(arrived).to(self.device, non_blocking=True),
            lr_host.to(self.device, non_blocking=True), lnorms=lnorms,
            health_on=prep.health_on)
        self._head_state = new_state
        self._inflight += 1
        self._inflight_rounds += 1
        return InFlightRound(new_state, None, metrics, [lr], prep.snapshot, stacked=False,
                             done=self._record(), host_batch={"tables": host},
                             masked=[prep.masked], requeue_depths=[len(prep.requeue)],
                             requeue=prep.requeue, requeue_ages=prep.requeue_ages,
                             cohorts=[prep.ids], health_on=[prep.health_on])

    def _fold_wire_copies(self) -> None:
        for direction, nbytes, t0, t1 in self._wire_copies:
            t1.synchronize()
            d = self._wire_totals.setdefault(direction, {"copies": 0, "bytes": 0, "ms": 0.0})
            d["copies"] += 1
            d["bytes"] += nbytes
            d["ms"] += t0.elapsed_time(t1)
        self._wire_copies = []

    def wire_copy_stats(self) -> dict:
        """Bytes and CUDA-event milliseconds of the served payload rounds'
        table-stack copies since the last call, by direction ("d2h": the
        client tables to the host, "h2d": the validated stack back):
        {direction: {"copies", "bytes", "ms"}}. Waits for the last copy."""
        self._fold_wire_copies()
        out, self._wire_totals = self._wire_totals, {}
        return out

    def _head(self) -> dict:
        return self._head_state if self._head_state is not None else self.state

    def _head_clients(self) -> dict | None:
        return (self._head_client_state if self._head_client_state is not None
                else self.client_state)

    def dispatch_round(self, prep: PreparedRound, lr: float) -> InFlightRound:
        """Launch one round without a host sync, chained on the newest
        dispatched state. The caller commits in dispatch order."""
        if self.fault_plan is not None:
            # a real SIGTERM that the run loop's PreemptionHandler turns into
            # drain -> emergency checkpoint -> resumable exit
            self.fault_plan.preempt(prep.rnd)
        if prep.payload is not None:
            return self._dispatch_payload_merge(prep, lr)
        lr_host = self._host(np.asarray(lr, np.float32))
        cstate = self._head_clients()
        rows, ids = {}, None
        if cstate is not None:
            ids = self._host(prep.ids.astype(np.int64)).to(self.device, non_blocking=True)
            rows = {k: v.index_select(0, ids) for k, v in cstate.items()}
        new_state, new_rows, metrics = self._step(
            self._head(), self._to_device(prep.batch), rows,
            lr_host.to(self.device, non_blocking=True))
        new_cstate = None
        if cstate is not None:
            # out of place: the committed client state stays as it was
            new_cstate = {k: v.index_copy(0, ids, new_rows[k]) for k, v in cstate.items()}
            self._head_client_state = new_cstate
        self._head_state = new_state
        self._inflight += 1
        self._inflight_rounds += 1
        return InFlightRound(new_state, new_cstate, metrics, [lr], prep.snapshot,
                             stacked=False, done=self._record(), host_batch=prep.batch,
                             masked=[prep.masked], requeue_depths=[len(prep.requeue)],
                             requeue=prep.requeue, requeue_ages=prep.requeue_ages,
                             cohorts=[prep.ids], health_on=[prep.health_on])

    def dispatch_block(self, preps: list[PreparedRound], lrs) -> InFlightRound:
        """Launch K rounds in one call (``engine.make_multi_round_step``)
        without a host sync: the K batches are stacked on the host into one
        [K, W, ...] tensor per key (pinned on the GPU) and copied to the
        device once, with the [K] learning rates."""
        lrs = list(lrs)
        host = {k: self._stack([p.batch[k] for p in preps]) for k in preps[0].batch}
        lrs_host = self._host(np.asarray(lrs, np.float32))
        new_state, metrics = self._multi(self._head(), self._to_device(host),
                                         lrs_host.to(self.device, non_blocking=True))
        self._head_state = new_state
        self._inflight += 1
        self._inflight_rounds += len(lrs)
        return InFlightRound(new_state, None, metrics, lrs, preps[-1].snapshot, stacked=True,
                             done=self._record(), host_batch=host,
                             masked=[p.masked for p in preps],
                             requeue_depths=[len(p.requeue) for p in preps],
                             requeue=preps[-1].requeue, requeue_ages=preps[-1].requeue_ages,
                             cohorts=[p.ids for p in preps],
                             health_on=[p.health_on for p in preps])

    def _stack(self, xs: list) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.stack(xs)
        out = torch.empty((len(xs), *xs[0].shape), dtype=xs[0].dtype, pin_memory=True)
        return torch.stack(xs, out=out)

    @staticmethod
    def fetch_metrics(infls: list[InFlightRound]) -> list[dict]:
        """The host values of every metric of ``infls``, in one
        device-to-host copy (the drain's one sync): per dispatch, a dict of
        floats, or of [K] lists for a block; a metric with an axis of its
        own (the health block's ``leaf_norms``) comes as nested lists."""
        parts = [v.reshape(-1).float() for fl in infls for v in fl.metrics.values()]
        flat = torch.cat(parts).cpu().tolist() if parts else []
        out, pos = [], 0
        for fl in infls:
            host = {}
            for k, v in fl.metrics.items():
                n = v.numel()
                if v.dim() == 0:
                    host[k] = flat[pos]
                elif v.dim() == 1 and fl.stacked:
                    host[k] = flat[pos:pos + n]
                else:
                    host[k] = np.asarray(flat[pos:pos + n]).reshape(v.shape).tolist()
                pos += n
            out.append(host)
        return out

    def commit_round(self, infl: InFlightRound, metrics_host: dict | None = None) -> list[dict]:
        """Publish one dispatched round or block: sync its metrics (unless
        the caller already fetched them) and commit it."""
        if metrics_host is None:
            metrics_host = self.fetch_metrics([infl])[0]
        return self.commit_rounds([infl], [metrics_host])

    def commit_rounds(self, infls: list[InFlightRound], metrics_hosts: list) -> list[dict]:
        """Batch commit of a drained pipeline, in dispatch order, under one
        ``mutate_lock`` hold: every round's metrics, communication and round
        counter run, and the newest dispatch's state, done-event and RNG
        snapshot are published, so a concurrent checkpoint sees either the
        view before the drain or the whole drained one."""
        out, obs_records = [], []
        with self.mutate_lock:
            for infl, mh in zip(infls, metrics_hosts):
                # the reserved obs prefixes never reach a row or a total
                mh = dict(mh)
                obs = {pre: {k[len(pre):]: mh.pop(k) for k in [k for k in mh
                                                               if k.startswith(pre)]}
                       for pre in ("health/", "ledger/")}
                for i, lr in enumerate(infl.lrs):
                    pick = (lambda d: {k: v[i] for k, v in d.items()}) if infl.stacked else dict
                    m = self._finalize_metrics(pick(mh), lr, infl.masked[i],
                                               infl.requeue_depths[i])
                    out.append(m)
                    obs_records.append((self.round - 1, infl.cohorts[i] if infl.cohorts else None,
                                        m, pick(obs["health/"]), pick(obs["ledger/"]),
                                        infl.health_on[i] if infl.health_on else False))
                self._inflight -= 1
                self._inflight_rounds -= infl.num_rounds
            last = infls[-1]
            if last.new_state is None:
                raise RuntimeError("commit_rounds: the newest in-flight dispatch has no state "
                                   "(release_state must only be called on superseded entries)")
            self.state = last.new_state
            if last.new_client_state is not None:
                self.client_state = last.new_client_state
            self.committed_event = last.done
            self.rng_snapshot = last.snapshot
            self._requeue_committed = last.requeue
            self._requeue_ages_committed = last.requeue_ages
            if self._inflight == 0:
                self._head_state = None
                self._head_client_state = None
        # outside the lock: the sinks do host conversion and file IO, which an
        # emergency checkpoint from the watchdog thread must never wait on
        if self.health_monitor is not None or self.slo is not None or self.ledger is not None:
            self._publish_round_obs(obs_records)
        return out

    def _publish_round_obs(self, records: list) -> None:
        """Hand each just-committed round to the attached obs sinks, in
        dependency order: the health monitor (its block feeds the others),
        the SLO engine, then the durable ledger append — the one place a
        round reaches the ledger, after it committed. Every value is host
        data already: the drain's one copy carried it."""
        for rnd, ids, m, health, fp, health_on in records:
            block = None
            if self.health_monitor is not None and health_on and health:
                block = self.health_monitor.on_round(rnd, health, m)
            if self.slo is not None:
                self.slo.on_round(rnd, m, block)
            if self.ledger is not None:
                self.ledger.append_round(rnd, cohort=ids, metrics=m, health=block,
                                         fingerprint=fp)

    def run_round(self, lr: float) -> dict:
        """Prepare, dispatch and commit one round; returns its host metrics."""
        return self.commit_round(self.dispatch_round(self.prepare_round(self.round), lr))[0]

    @property
    def supports_block_dispatch(self) -> bool:
        """Whether a block of rounds can run in one dispatch: not for a mode
        with client state (its rows are gathered and scattered around each
        round), nor with a fault plan (its sites are scheduled by round,
        which a block cannot honour), nor for the per-client-table round
        (its wire crossing, or the batch twin of it, is the round
        boundary)."""
        return (self.client_state is None and self.fault_plan is None
                and self._payload_client is None)

    def run_rounds(self, lrs) -> list[dict]:
        """len(lrs) rounds in one dispatch and one sync, with the same host
        RNG draws as that many ``run_round`` calls."""
        lrs = list(lrs)
        if not self.supports_block_dispatch or len(lrs) <= 1:
            return [self.run_round(lr) for lr in lrs]
        preps = [self.prepare_round(self.round + i) for i in range(len(lrs))]
        return self.commit_round(self.dispatch_block(preps, lrs))

    def _finalize_metrics(self, m: dict, lr: float, masked: int = 0,
                          requeue_depth: int = 0) -> dict:
        """Host bookkeeping of a committed round: the cohort counters (how
        many clients the validity mask killed, how deep the queue ran at
        preparation), communication (uplink charged for the clients that
        uploaded, the measured local_topk down-link), totals and the round
        counter."""
        m = {k: float(v) for k, v in m.items()}
        m["lr"] = float(lr)
        m["clients_dropped"] = float(masked)
        m["requeue_depth"] = float(requeue_depth)
        self.clients_quarantined_total += int(m.get("clients_quarantined", 0))
        m.update(self.comm_per_round)
        if (self.cfg.client_dropout > 0 or masked) and "participants" in m:
            # a dropped or masked client never transmits; a quarantined one
            # did upload (the server rejected it after), so it stays
            # charged; the broadcast still reaches the whole cohort
            uploaded = m["participants"] + m.get("clients_quarantined", 0.0)
            m["comm_up_mb"] *= uploaded / self.num_workers
            m["comm_total_mb"] = m["comm_up_mb"] + m["comm_down_mb"]
        if "down_support" in m:
            # local_topk: the round's measured broadcast support replaces the
            # static worst case; past the sparse/dense crossover a server
            # would send dense floats, so the cost is capped there
            per_client = min(m.pop("down_support") * BYTES_PAIR, self.cfg.mode.d * BYTES_F32)
            m["comm_down_mb"] = per_client * self.num_workers / 1e6
            m["comm_total_mb"] = m["comm_up_mb"] + m["comm_down_mb"]
        self.comm_mb_total += m["comm_total_mb"]
        self.round += 1
        return m

    def evaluate(self, dataset: FedDataset, batch_size: int = 512) -> dict:
        """Forward-only metric sums over the whole eval set, on the committed
        state; refuses while rounds are in flight."""
        if self._inflight:
            raise RuntimeError(
                f"evaluate() with {self._inflight} uncommitted in-flight dispatch(es): the "
                "run loop must drain the pipeline before an eval boundary")
        if self.fault_plan is not None:
            self.fault_plan.eval_load(self.round)
        totals: dict[str, torch.Tensor] = {}
        for batch in dataset.eval_batches(batch_size):
            metrics = self._eval(self.state["params"], self.state["net_state"],
                                 self._to_device(batch))
            for k, v in metrics.items():
                totals[k] = totals[k] + v if k in totals else v
        return {k: float(v) for k, v in totals.items()}

    def params(self) -> dict:
        """The current parameters, by the model's names, in its layouts."""
        return self.layout.unflatten(self.state["params"])


class FedModel:
    """Reference ``FedModel`` parity: calling it runs one federated round
    and returns its metrics; ``.eval()`` runs the forward-only pass."""

    def __init__(self, session: FederatedSession):
        self.session = session

    def __call__(self, lr: float) -> dict:
        return self.session.run_round(lr)

    def eval(self, dataset: FedDataset, batch_size: int = 512) -> dict:
        return self.session.evaluate(dataset, batch_size)

    @property
    def params(self) -> dict:
        return self.session.params()


def plan_block(opt: "FedOptimizer", rnd: int, total_rounds: int, eval_every: int,
               checkpoint_every: int, rounds_per_dispatch: int) -> list[float]:
    """Per-round lrs for the next dispatch block, truncated at the run end
    and at any eval or checkpoint boundary so the logging and saving cadence
    does not depend on the block size. Advances the optimizer schedule."""
    block = min(max(rounds_per_dispatch, 1), total_rounds - rnd,
                eval_every - rnd % eval_every,
                *((checkpoint_every - rnd % checkpoint_every,) if checkpoint_every else ()))
    lrs = []
    for _ in range(block):
        lrs.append(opt.lr)
        opt.step()
    return lrs


class FedOptimizer:
    """Reference ``FedOptimizer`` parity: owns the LR schedule; the server
    update itself ran inside the round step, so ``step()`` only advances
    the schedule."""

    def __init__(self, schedule: Callable[[float], float], rounds_per_epoch: int):
        self.schedule = schedule
        self.rounds_per_epoch = max(rounds_per_epoch, 1)
        self._round = 0

    @property
    def round(self) -> int:
        return self._round

    @round.setter
    def round(self, value: int):
        self._round = int(value)

    @property
    def lr(self) -> float:
        return float(self.schedule(self._round / self.rounds_per_epoch))

    def step(self):
        self._round += 1
