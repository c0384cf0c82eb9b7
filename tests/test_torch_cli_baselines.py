"""The port's CLI against the JAX package's on the baseline modes, on the
CPU, the same flags through both ``cv_train.main``:

- FEMNIST true_topk and FEMNIST fedavg with 2 local iterations, at full
  FEMNIST CNN width (the port's model starts from the flax init of the same
  seed): every eval row's losses, accuracies and comm_mb within 1e-5
  (the two packages' CPU convolutions sum in different orders);
- local_topk's measured down-link accounting (the twins of
  tests/test_engine.py::test_run_rounds_local_topk_virtual_downlink_accounting
  and tests/test_client_state_sharding.py's two down-byte tests): the
  tiny MLP of tests/test_torch_loop_parity.py, every round's cumulative
  comm_mb equal to the reference's, at most the static worst case and
  capped at the dense-float cost.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cv_train as jcv
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.femnist_cnn import FEMNISTCNN
from commefficient_tpu_torch.utils.comm import BYTES_F32, BYTES_PAIR
from test_torch_loop_parity import both_tiny  # noqa: F401

torch.set_num_threads(2)

ROW_KEYS = ("train_loss", "train_acc", "test_loss", "test_acc", "comm_mb")


@pytest.fixture()
def femnist_twin(monkeypatch):
    """The port's FEMNIST CNN starts from the flax init of the seed, as the
    JAX CLI's does."""
    from commefficient_tpu.models.femnist_cnn import FEMNISTCNN as JFEMNIST

    def init_from_flax(model, seed):
        assert isinstance(model, FEMNISTCNN)
        params = JFEMNIST().init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)),
                                 train=False)["params"]
        tparams, _ = convert.params_from_flax(model, jax.tree.map(np.asarray, params), {})
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(tparams[name])

    monkeypatch.setattr(tcv, "init_weights", init_from_flax)


def _rows(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("mode", [["--mode", "true_topk", "--k", "20000"],
                                  ["--mode", "fedavg", "--num_local_iters", "2"]])
def test_femnist_cli_matches_jax(femnist_twin, tmp_path, mode):
    common = ["--dataset", "femnist", *mode, "--num_clients", "6", "--num_workers", "2",
              "--local_batch_size", "4", "--lr_scale", "0.05", "--data_root", "/nonexistent",
              "--num_rounds", "3", "--eval_every", "1", "--eval_batch_size", "64"]
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    js = jcv.main(common + ["--sync_loop", "--num_devices", "1", "--log_jsonl", jlog])
    ts = tcv.main(common + ["--device", "cpu", "--log_jsonl", tlog])
    assert js.round == ts.round == 3
    jrows, trows = _rows(jlog), _rows(tlog)
    assert [r["round"] for r in trows] == [r["round"] for r in jrows] == [1, 2, 3]
    for jr, tr in zip(jrows, trows):
        for k in ROW_KEYS:
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, atol=1e-7, err_msg=(tr, k))
    assert trows[-1]["comm_mb"] > 0


LOCAL_TOPK = {
    # virtual error: a k-sparse release, stateless per client
    "virtual": ["--k", "100", "--error_type", "virtual", "--momentum_type", "none"],
    # virtual momentum carries past rounds' coordinates: the support grows
    # past the dense crossover, where the accounting caps
    "capped": ["--k", "49333", "--error_type", "none", "--momentum_type", "virtual"],
    # the reference defaults: local error and local momentum
    "local": ["--k", "100"],
}


@pytest.mark.parametrize("case", list(LOCAL_TOPK))
def test_local_topk_downlink_accounting_matches_jax(both_tiny, tmp_path, case):
    common = ["--dataset", "cifar10", "--mode", "local_topk", *LOCAL_TOPK[case],
              "--num_clients", "8", "--num_workers", "2", "--local_batch_size", "4",
              "--lr_scale", "0.05", "--data_root", "/nonexistent", "--num_rounds", "5",
              "--eval_every", "1"]
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jcv.main(common + ["--sync_loop", "--num_devices", "1", "--log_jsonl", jlog])
    ts = tcv.main(common + ["--device", "cpu", "--log_jsonl", tlog])
    jrows, trows = _rows(jlog), _rows(tlog)
    assert [r["comm_mb"] for r in trows] == [r["comm_mb"] for r in jrows]
    mcfg, W = ts.cfg.mode, ts.num_workers
    up = mcfg.k * BYTES_PAIR * W / 1e6
    per_round = np.diff([0.0] + [r["comm_mb"] for r in trows])
    down = per_round - up
    worst = min(W * mcfg.k, mcfg.d) * BYTES_PAIR * W / 1e6
    dense = mcfg.d * BYTES_F32 * W / 1e6
    # the first round runs at lr 0 and releases nothing
    assert abs(down[0]) < 1e-9 and np.all(down[1:] > 0)
    assert np.all(down <= min(worst, dense) * (1 + 1e-6))
    if case == "capped":
        assert np.isclose(down[-1], dense, rtol=1e-6)
