"""fedavg at the parser's default of one local iteration, through the
port's session and CLI on the CPU with the tiny MLP twin of
tests/test_torch_runner.py: the twin of tests/test_engine.py's
``test_fedavg_single_local_iter_matches_sgd``. With one local step, no
momentum and server_lr 1, a fedavg round is one SGD step on the cohort's
mean gradient, which is what an uncompressed round without momentum takes
on the same batch (the sampler draws the same rows at L = 1)."""

import numpy as np
import torch

from commefficient_tpu_torch import cv_train
from test_torch_runner import _args, _argv, _rows, tiny_cv  # noqa: F401

torch.set_num_threads(2)

SGD = ["--momentum", "0", "--num_workers", "3"]


def test_fedavg_single_local_iter_matches_sgd(tiny_cv):
    fedavg, _ = cv_train.build(_args(SGD + ["--mode", "fedavg"]))
    sgd, _ = cv_train.build(_args(SGD))
    assert fedavg.cfg.mode.num_local_iters == 1
    p0 = fedavg.state["params"].clone()
    for lr in (0.2, 0.1):
        mf, ms = fedavg.run_round(lr), sgd.run_round(lr)
        assert float(mf["participants"]) == float(ms["participants"]) == 3.0
    np.testing.assert_allclose(fedavg.state["params"].numpy(), sgd.state["params"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not torch.equal(fedavg.state["params"], p0)


def test_fedavg_cli_default_local_iters_runs(tiny_cv, tmp_path):
    log = str(tmp_path / "rows.jsonl")
    s = cv_train.main(_argv(SGD + ["--mode", "fedavg", "--num_rounds", "3", "--eval_every",
                                   "3", "--log_jsonl", log]))
    assert s.round == 3
    rows = _rows(log)
    assert rows and all(np.isfinite(r["test_loss"]) for r in rows)
