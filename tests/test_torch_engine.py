"""The port's round engine and CLI on the CPU: the CLI's logged rows and
flags, the non-finite guard, and the client reduction. (The round's parity
with the JAX package is tests/test_torch_round.py.)"""

import json
import math

import numpy as np
import pytest
import torch

from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.losses import make_classification_loss
from commefficient_tpu_torch.models.resnet9 import ResNet9, init_weights
from commefficient_tpu_torch.modes.config import ModeConfig
from commefficient_tpu_torch.utils.comm import round_comm_mb

torch.set_num_threads(2)

# the JAX CLI's row columns (cv_train.py build_row)
ROW_COLUMNS = ["round", "epoch", "lr", "train_loss", "train_acc", "test_loss",
               "test_acc", "comm_mb", "time_s", "nonfinite_rounds"]


def test_cli_sketch_run_on_cpu_logs_the_reference_columns(tmp_path):
    log = tmp_path / "rows.jsonl"
    session = cv_train.main([
        "--device", "cpu", "--mode", "sketch", "--num_clients", "10",
        "--num_workers", "2", "--local_batch_size", "2", "--k", "500",
        "--num_cols", "65536", "--num_rounds", "3", "--eval_every", "2",
        "--synthetic_train", "100", "--data_root", str(tmp_path / "none"),
        "--log_jsonl", str(log)])
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["round"] for r in rows] == [2, 3]
    for r in rows:
        assert list(r)[1:] == ROW_COLUMNS  # after the JSONL schema field
        assert math.isfinite(r["train_loss"]) and math.isfinite(r["test_loss"])
        assert 0.0 <= r["test_acc"] <= 1.0
    per_round = round_comm_mb(session.cfg.mode, 2)["comm_total_mb"]
    assert rows[-1]["comm_mb"] == pytest.approx(3 * per_round)
    assert session.round == 3 and torch.isfinite(session.state["params"]).all()


def _setup(mode_kw, **eng_kw):
    model = ResNet9()
    init_weights(model, 0)
    layout = convert.FlatLayout(model)
    cfg = engine.EngineConfig(mode=ModeConfig(d=layout.d, **mode_kw), **eng_kw)
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = engine.init_server_state(cfg, layout.flatten(params),
                                     {k: b.clone() for k, b in model.named_buffers()})
    rng = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)),
             "y": torch.from_numpy(rng.randint(0, 10, (2, 2)).astype(np.int32)),
             "mask": torch.ones(2, 2), engine.VALID_KEY: torch.ones(2)}
    return make_classification_loss(model, True), layout, cfg, state, batch


def test_nonfinite_round_is_skipped():
    """on_nonfinite="skip": a NaN client makes the aggregate non-finite; the
    round aggregates zero (momentum decays, nothing else moves), keeps the
    previous batch-norm statistics and says so in nonfinite_rounds."""
    mode_kw = dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                   error_type="none")
    loss_fn, layout, cfg, state, batch = _setup(mode_kw, on_nonfinite="skip")
    v0 = torch.randn(layout.d, generator=torch.Generator().manual_seed(1))
    state["mode_state"]["Vvelocity"] = v0.clone()
    batch["x"][1, 0, 0, 0, 0] = float("nan")
    new, _, metrics = engine.make_round_step(loss_fn, cfg, layout)(state, batch, {}, 0.1)
    assert metrics["nonfinite_rounds"].item() == 1.0
    assert metrics["loss_sum"].item() == 0.0 and metrics["participants"].item() == 2.0
    assert torch.equal(new["mode_state"]["Vvelocity"], 0.9 * v0)
    torch.testing.assert_close(new["params"], state["params"] - 0.1 * (0.9 * v0),
                               rtol=0, atol=0)
    for k, t in new["net_state"].items():
        assert torch.equal(t, state["net_state"][k]), k



@pytest.mark.parametrize("flag", [["--dtype", "bfloat16"], ["--client_chunk", "4"],
                                  ["--sketch_path", "layerwise"]])
def test_cli_rejects_reference_flags_the_port_does_not_honour(flag):
    """A flag of the JAX CLI that the port does not run is refused, not
    accepted and ignored."""
    with pytest.raises(SystemExit):
        cv_train.make_parser().parse_args(["--device", "cpu", *flag])


@pytest.mark.parametrize("valid", [[1.0, 1.0], [1.0, 0.0], [0.0, 0.0]],
                         ids=["all_live", "nan_client_dropped", "all_dropped"])
def test_client_reduce_equals_survivor_mean_of_client_gradients(valid):
    """reduce_clients folds the clients one by one; the result must be,
    bitwise, the survivor mean of each client's own gradient (+ weight
    decay), batch-norm statistics and metric sums, computed client by
    client here. A dropped client carries a NaN image, which must
    contribute an exact zero; with nobody left the statistics stay as
    they were and the update is zero."""
    mode_kw = dict(mode="uncompressed", momentum=0.9, momentum_type="virtual",
                   error_type="none")
    loss_fn, layout, cfg, state, batch = _setup(mode_kw, weight_decay=5e-4)
    batch[engine.VALID_KEY] = torch.tensor(valid)
    if valid[1] == 0.0:
        batch["x"][1, 0, 0, 0, 0] = float("nan")
    weighted, stats, metrics = engine.reduce_clients(loss_fn, cfg, layout, state, batch)

    pflat = state["params"]
    grads, client_stats, client_metrics = [], [], []
    for w in range(2):
        if not valid[w]:
            continue
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in layout.unflatten(pflat).items()}
        cbatch = {k: v[w] for k, v in batch.items() if k != engine.VALID_KEY}
        loss, aux = loss_fn(leaves, state["net_state"], cbatch)
        g = torch.autograd.grad(loss, list(leaves.values()))
        grads.append(layout.flatten(dict(zip(leaves, g))) + 5e-4 * pflat)
        client_stats.append({k: v.detach() for k, v in aux["net_state"].items()})
        client_metrics.append({k: v.detach() for k, v in aux["metrics"].items()})
    n = max(len(grads), 1)
    exact = dict(rtol=0, atol=0)
    want = sum(grads[1:], grads[0]) / n if grads else torch.zeros_like(pflat)
    torch.testing.assert_close(weighted, want, **exact)
    for k, prev in state["net_state"].items():
        want = (sum(s[k] for s in client_stats[1:]) + client_stats[0][k]) / n \
            if client_stats else prev
        torch.testing.assert_close(stats[k], want, **exact)
    for k in ("loss_sum", "count", "correct"):
        want = sum(float(m[k]) for m in client_metrics)
        assert metrics[k].item() == pytest.approx(want, rel=1e-7, abs=0), k
    assert metrics["participants"].item() == sum(valid)
