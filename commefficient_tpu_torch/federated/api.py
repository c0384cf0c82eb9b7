"""The user-facing federated session: the PyTorch twin of the JAX package's
``federated/api.py`` for the single-device round.

``FederatedSession`` owns the server state (flat params, batch-norm
statistics, Vvelocity/Verror), the client state (local_topk's
[num_clients, d] local error and momentum, when the mode keeps any), the
host sampling stream and the communication accounting. A round runs in
three steps, so the run loop (``runner/``) can overlap them:

- ``prepare_round``: sample the cohort and assemble its batch on the host
  (pinned host tensors when the session runs on the GPU); any thread, one
  at a time, in round order.
- ``dispatch_round`` / ``dispatch_block``: copy the batch to the device
  without a host sync and launch the round's work, chained on the newest
  dispatched state; returns device metrics. A round of a mode with client
  state gathers the cohort's rows before its step and scatters the new
  rows after it, out of place: a new [num_clients, d] tensor per key, so a
  committed client state is never written again (checkpoints copy it while
  later rounds run).
- ``commit_rounds``: publish state, client state, round counter,
  communication totals and the host-RNG snapshot, in dispatch order, under
  ``mutate_lock``.

``FedModel`` and ``FedOptimizer`` mirror the reference's
``FedModel(model, loss_fn, args)`` / ``FedOptimizer(opt, args)`` surface.
The session runs on the GPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..data.fed_dataset import FedDataset
from ..models.convert import FlatLayout
from ..modes import modes
from ..modes.config import ModeConfig
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
    prefetcher has already advanced the live stream."""

    rnd: int
    ids: np.ndarray
    batch: dict
    snapshot: tuple


@dataclasses.dataclass
class InFlightRound:
    """A dispatched, uncommitted round or block of rounds, with the server
    state and client state (None when the mode keeps none) it produced.
    ``metrics`` stay device tensors until the run loop drains them.
    ``done`` is the CUDA event recorded after the dispatch (None on the
    CPU): a checkpoint of this state waits for it alone. ``host_batch`` keeps the pinned source of
    the non-blocking copy referenced until commit."""

    new_state: dict | None
    new_client_state: dict | None
    metrics: dict
    lrs: list
    snapshot: tuple
    stacked: bool  # block dispatch: every metric has a leading [K] axis
    done: Any = None
    host_batch: dict | None = None

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
    ):
        self.device = resolve_device(device)
        if layout.d != mode_cfg.d:
            raise ValueError(f"mode_cfg.d={mode_cfg.d} but the model has d={layout.d}")
        if on_nonfinite not in ("off", "skip", "halt"):
            raise ValueError(f"on_nonfinite must be 'off', 'skip' or 'halt', got "
                             f"{on_nonfinite!r}")
        self.train_set = train_set
        self.num_workers = min(num_workers, train_set.num_clients)
        self.local_batch_size = local_batch_size
        # "halt" is the run loop's policy on top of the step's "skip"
        self.cfg = engine.EngineConfig(
            mode=mode_cfg, weight_decay=weight_decay,
            on_nonfinite="skip" if on_nonfinite == "halt" else on_nonfinite)
        self.layout = layout
        pflat = layout.flatten({k: v.detach().to(self.device) for k, v in params.items()})
        self.state = engine.init_server_state(
            self.cfg, pflat, {k: v.detach().to(self.device).clone() for k, v in net_state.items()})
        # [num_clients, d] per key, or None
        self.client_state = modes.init_client_state(mode_cfg, train_set.num_clients,
                                                    self.device)
        self.train_loss_fn = train_loss_fn
        self._step = engine.make_round_step(train_loss_fn, self.cfg, layout)
        self._multi = (None if mode_cfg.needs_local_state
                       else engine.make_multi_round_step(train_loss_fn, self.cfg, layout))
        self._eval = engine.make_eval_step(eval_loss_fn, layout)
        self.fault_plan = fault_plan
        self.retry_policy = retry_policy or rtry.RetryPolicy()
        self.rng = np.random.RandomState(seed)
        self._snapshot_rng()
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
        self.run_stats = None  # the RunStats of the last run_loop that finished

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
        port's path draws nothing on the device (no dropout, no DP noise), so
        the host RandomState is the whole RNG state of a round boundary."""
        self.rng_snapshot = self.rng.get_state()

    def _host(self, a: np.ndarray) -> torch.Tensor:
        """A host tensor of ``a``, pinned when the session runs on the GPU."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, batch: dict) -> dict:
        """Copy a batch of host tensors (or numpy arrays) to the session's
        device. From pinned memory the copy is queued without a host sync."""
        return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v)))
                .to(self.device, non_blocking=True) for k, v in batch.items()}

    def _record(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def sample_cohort(self, rnd: int) -> np.ndarray:
        """Draw the round's cohort from the host sampling stream."""
        return self.train_set.sample_clients(self.rng, self.num_workers)

    def _load_client_batch(self, ids: np.ndarray, rnd: int) -> dict:
        """Batch assembly behind the retry wrapper. The fault site fires
        before any host RNG is drawn and a failed attempt restores the RNG,
        so a retried load replays the identical batch. A load that still
        fails after the retries raises (the reference instead degrades the
        round to a masked cohort and re-queues it; requeue is not ported)."""

        def attempt():
            rng_state = self.rng.get_state()
            try:
                if self.fault_plan is not None:
                    self.fault_plan.data_load(rnd)
                mcfg = self.cfg.mode
                batch = self.train_set.client_batch(self.rng, ids, self.local_batch_size,
                                                    mcfg.num_local_iters)
                if mcfg.uses_weight_delta and mcfg.num_local_iters == 1:
                    # the sampler drops the [L] axis at L = 1; the local-SGD
                    # loop reads microbatches off it
                    batch = {k: v[:, None] for k, v in batch.items()}
                return batch
            except Exception:
                self.rng.set_state(rng_state)
                raise

        return rtry.with_retries(attempt, site="data_load", policy=self.retry_policy,
                                 seed=rnd)

    def prepare_round(self, rnd: int | None = None) -> PreparedRound:
        """Host half of a round: sample the cohort, assemble the batch (fault
        sites at ``rnd``), pin it. Draws from the live host stream in round
        order: one producer at a time, sequentially."""
        if rnd is None:
            rnd = self.round + self._inflight_rounds
        ids = self.sample_cohort(rnd)
        batch = self._load_client_batch(ids, rnd)
        if self.fault_plan is not None:
            batch = self.fault_plan.poison(rnd, batch)
        # the validity mask always rides the batch (all ones here)
        batch[engine.VALID_KEY] = np.ones(len(ids), np.float32)
        return PreparedRound(rnd, ids, {k: self._host(v) for k, v in batch.items()},
                             self.rng.get_state())

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
                             stacked=False, done=self._record(), host_batch=prep.batch)

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
                             done=self._record(), host_batch=host)

    def _stack(self, xs: list) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.stack(xs)
        out = torch.empty((len(xs), *xs[0].shape), dtype=xs[0].dtype, pin_memory=True)
        return torch.stack(xs, out=out)

    @staticmethod
    def fetch_metrics(infls: list[InFlightRound]) -> list[dict]:
        """The host values of every metric of ``infls``, in one
        device-to-host copy (the drain's one sync): per dispatch, a dict of
        floats, or of [K] lists for a block."""
        parts = [v.reshape(-1).float() for fl in infls for v in fl.metrics.values()]
        flat = torch.cat(parts).cpu().tolist() if parts else []
        out, pos = [], 0
        for fl in infls:
            host = {}
            for k, v in fl.metrics.items():
                n = v.numel()
                host[k] = flat[pos:pos + n] if fl.stacked else flat[pos]
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
        out = []
        with self.mutate_lock:
            for infl, mh in zip(infls, metrics_hosts):
                if infl.stacked:
                    for i, lr in enumerate(infl.lrs):
                        out.append(self._finalize_metrics({k: v[i] for k, v in mh.items()}, lr))
                else:
                    out.append(self._finalize_metrics(mh, infl.lrs[0]))
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
            if self._inflight == 0:
                self._head_state = None
                self._head_client_state = None
        return out

    def run_round(self, lr: float) -> dict:
        """Prepare, dispatch and commit one round; returns its host metrics."""
        return self.commit_round(self.dispatch_round(self.prepare_round(self.round), lr))[0]

    @property
    def supports_block_dispatch(self) -> bool:
        """Whether a block of rounds can run in one dispatch: not for a mode
        with client state (its rows are gathered and scattered around each
        round), nor with a fault plan (its sites are scheduled by round,
        which a block cannot honour)."""
        return self.client_state is None and self.fault_plan is None

    def run_rounds(self, lrs) -> list[dict]:
        """len(lrs) rounds in one dispatch and one sync, with the same host
        RNG draws as that many ``run_round`` calls."""
        lrs = list(lrs)
        if not self.supports_block_dispatch or len(lrs) <= 1:
            return [self.run_round(lr) for lr in lrs]
        preps = [self.prepare_round(self.round + i) for i in range(len(lrs))]
        return self.commit_round(self.dispatch_block(preps, lrs))

    def _finalize_metrics(self, m: dict, lr: float) -> dict:
        m = {k: float(v) for k, v in m.items()}
        m["lr"] = float(lr)
        m.update(self.comm_per_round)
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
