"""The PyTorch port stands alone: no module of ``commefficient_tpu_torch``,
and not ``chip_smoke.py``, imports JAX, flax, optax, orbax, anything of
the JAX package, ``transformers`` or ``safetensors`` (the GPU machine has
neither); importing the port pulls none of them in; and its entry
points run on the GPU unless told otherwise, raising when there is none."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "commefficient_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "commefficient_tpu", "transformers",
             "safetensors")
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]

torch.set_num_threads(2)


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_forbidden_imports(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = _imported_roots(tree) & set(FORBIDDEN)
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import commefficient_tpu_torch, commefficient_tpu_torch.cv_train\n"
        "for m in pkgutil.walk_packages(commefficient_tpu_torch.__path__,\n"
        "                               'commefficient_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_session_defaults_to_cuda_and_raises_without_it(no_gpu):
    from commefficient_tpu_torch.data.cifar import load_cifar_fed
    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.models.convert import FlatLayout
    from commefficient_tpu_torch.models.losses import make_classification_loss
    from commefficient_tpu_torch.models.resnet9 import ResNet9
    from commefficient_tpu_torch.modes.config import ModeConfig

    train, _, _ = load_cifar_fed("cifar10", 4, False, "/nonexistent", 0,
                                 synthetic_train=64, synthetic_test=8)
    model = ResNet9()
    layout = FlatLayout(model)
    kw = dict(
        train_loss_fn=make_classification_loss(model, True),
        eval_loss_fn=make_classification_loss(model, False),
        params=dict(model.named_parameters()), net_state=dict(model.named_buffers()),
        layout=layout, mode_cfg=ModeConfig(mode="uncompressed", d=layout.d,
                                           momentum_type="none", error_type="none"),
        train_set=train, num_workers=2, local_batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedSession(**kw)
    session = FederatedSession(**kw, device="cpu")
    assert session.state["params"].device.type == "cpu"
    assert np.isfinite(session.run_round(0.01)["loss_sum"])


def test_cli_defaults_to_cuda_and_raises_without_it(no_gpu):
    from commefficient_tpu_torch import cv_train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cv_train.main(["--num_rounds", "1", "--data_root", "/nonexistent"])
