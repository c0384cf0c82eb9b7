"""Nothing the benchmark runs imports JAX or the JAX package: an AST scan
of every module under ``perfbench/`` (top-level names compared whole, so
the port's ``commefficient_tpu_torch`` passes), and a process that imports
``perfbench.run`` and builds a tiny cell on the CPU ends with neither in
``sys.modules``. The reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from .tiny import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "commefficient_tpu"}


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _modules(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax():
    found = {p: _imports(p) & BANNED for p in _modules()}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_port():
    for p in _modules("reference"):
        assert not {n for n in _imports(p) if n.startswith("commefficient")}, p


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import perfbench.run\n"
        "from perfbench import harness\n"
        "from perfbench.tests import tiny\n"
        f"root = tiny.make_root({str(tmp_path)!r})\n"
        "run = harness.build(harness.load_cell(root, 'tiny-gpt2-sketch'), 3, 'cpu')\n"
        "harness.checked_rounds(run)\n"
        "print('LOADED', harness.jax_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_jax_modules_compares_whole_names(monkeypatch):
    from perfbench import harness

    monkeypatch.setitem(sys.modules, "commefficient_tpu_torch_x", sys)
    assert harness.jax_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.jax_modules() == ["flax"]
