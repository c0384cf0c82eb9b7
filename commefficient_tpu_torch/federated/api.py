"""The user-facing federated session: the PyTorch twin of the JAX package's
``federated/api.py`` for the synchronous single-device round.

``FederatedSession`` owns the server state (flat params, batch-norm
statistics, Vvelocity/Verror), the host sampling stream and the
communication accounting. ``FedModel`` and ``FedOptimizer`` mirror the
reference's ``FedModel(model, loss_fn, args)`` / ``FedOptimizer(opt, args)``
surface. The session runs on the GPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..data.fed_dataset import FedDataset
from ..models.convert import FlatLayout
from ..modes.config import ModeConfig
from ..utils.comm import round_comm_mb
from ..utils.device import resolve_device
from . import engine


@dataclasses.dataclass
class PreparedRound:
    """Host-side half of a round: the cohort and its assembled batch."""

    rnd: int
    ids: np.ndarray
    batch: dict  # numpy arrays with leading axis W, plus engine.VALID_KEY


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
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if layout.d != mode_cfg.d:
            raise ValueError(f"mode_cfg.d={mode_cfg.d} but the model has d={layout.d}")
        self.train_set = train_set
        self.num_workers = min(num_workers, train_set.num_clients)
        self.local_batch_size = local_batch_size
        self.cfg = engine.EngineConfig(mode=mode_cfg, weight_decay=weight_decay,
                                       on_nonfinite=on_nonfinite)
        self.layout = layout
        pflat = layout.flatten({k: v.detach().to(self.device) for k, v in params.items()})
        self.state = engine.init_server_state(
            self.cfg, pflat, {k: v.detach().to(self.device).clone() for k, v in net_state.items()})
        self.train_loss_fn = train_loss_fn
        self._step = engine.make_round_step(train_loss_fn, self.cfg, layout)
        self._eval = engine.make_eval_step(eval_loss_fn, layout)
        self.rng = np.random.RandomState(seed)
        self.round = 0
        self.comm_per_round = round_comm_mb(mode_cfg, self.num_workers)
        self.comm_mb_total = 0.0
        self.round_ms: list[float] = []  # wall time of each run_round, synced

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def sample_cohort(self, rnd: int) -> np.ndarray:
        """Draw the round's cohort from the host sampling stream."""
        return self.train_set.sample_clients(self.rng, self.num_workers)

    def prepare_round(self, rnd: int | None = None) -> PreparedRound:
        """Sample the cohort and assemble its batch on the host; the
        validity mask always rides the batch (all ones here)."""
        if rnd is None:
            rnd = self.round
        ids = self.sample_cohort(rnd)
        batch = self.train_set.client_batch(self.rng, ids, self.local_batch_size)
        batch[engine.VALID_KEY] = np.ones(len(ids), np.float32)
        return PreparedRound(rnd, ids, batch)

    def run_round(self, lr: float) -> dict:
        """Prepare, run and commit one round; returns its host metrics."""
        t0 = time.perf_counter()
        prep = self.prepare_round(self.round)
        new_state, metrics = self._step(self.state, self._to_device(prep.batch), lr)
        m = {k: float(v) for k, v in metrics.items()}  # the round's one sync
        self.state = new_state
        self.round_ms.append((time.perf_counter() - t0) * 1e3)
        return self._finalize_metrics(m, lr)

    def _finalize_metrics(self, m: dict, lr: float) -> dict:
        m["lr"] = float(lr)
        m.update(self.comm_per_round)
        self.comm_mb_total += m["comm_total_mb"]
        self.round += 1
        return m

    def evaluate(self, dataset: FedDataset, batch_size: int = 512) -> dict:
        """Forward-only metric sums over the whole eval set."""
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
