"""Reproducibility of the port, the twin of tests/test_determinism.py: two
fresh processes of one seeded CLI configuration must write byte-identical
JSONL rows (the wall clock aside). The run uses local_topk with its
default client state on the FEMNIST CNN, so batch assembly, the host RNG,
the client fold, the per-client top-k and the client-state scatter are all
in it.

On the GPU the entry point makes the same promise with its own switches
(``utils/device.py::make_reproducible``, which the CLI's ``build`` calls); the unit check of those switches
needs a card and skips here. Its card counterpart is ``chip_smoke.py``
phase 8a, which holds two sync runs bitwise equal."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, tag):
    log = tmp_path / f"{tag}.jsonl"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "commefficient_tpu_torch.cv_train", "--device", "cpu",
         "--dataset", "femnist", "--mode", "local_topk", "--k", "5000", "--num_clients", "12",
         "--num_workers", "3", "--local_batch_size", "4", "--num_rounds", "4",
         "--eval_every", "2", "--seed", "7", "--data_root", str(tmp_path / "none"),
         "--log_jsonl", str(log)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return log.read_text()


def test_same_seed_two_processes_bit_identical(tmp_path):
    a, b = _run(tmp_path, "a"), _run(tmp_path, "b")

    def strip(txt):
        return [{k: v for k, v in json.loads(ln).items() if k != "time_s"}
                for ln in txt.splitlines()]

    rows = strip(a)
    assert [r["round"] for r in rows] == [2, 4]
    assert rows == strip(b)


@pytest.mark.cuda
def test_resolve_device_cuda_sets_the_reproducibility_switches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the switches are set for the GPU only")
    from commefficient_tpu_torch import cv_train
    from commefficient_tpu_torch.utils.device import make_reproducible, resolve_device

    was = torch.are_deterministic_algorithms_enabled()
    try:
        # the CLI's build turns them on; a second call changes nothing
        assert cv_train.make_reproducible is make_reproducible
        make_reproducible()
        make_reproducible()
        dev = resolve_device("cuda")
        assert dev.type == "cuda" and dev.index is not None
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.utils.deterministic.fill_uninitialized_memory
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (":4096:8", ":16:8")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.use_deterministic_algorithms(was)
