"""Child processes of the scale-out layer: the shard workers
(``procshard_worker.py``) and the load generator's clients
(``loadgen.py``).

``start_child`` runs ``python -m commefficient_tpu_torch.serve.scale.spawn
<fd>`` with one end of a socket pair as the child's control connection
(``multiprocessing.connection.Connection``, the object ``multiprocessing.
Pipe`` makes), sends it ``(target, args)``, and the child calls
``target(*args, ctl)``. Unlike multiprocessing's "spawn" start method the
child never re-imports the parent's ``__main__`` (a CLI or a test module
that imports torch): it imports this package's lazy ``__init__``s and the
target's module, numpy and the standard library, so it starts in a
fraction of a second and never holds a CUDA context.
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
from multiprocessing.connection import Connection

# the directory holding the package: the child's import root, wherever the
# parent process runs from
_IMPORT_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def start_child(target: str, args: tuple) -> tuple[subprocess.Popen, Connection]:
    """Start ``target`` ("module:function") in a child process; returns the
    process and the parent's end of its control connection."""
    parent, child = socket.socketpair()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_IMPORT_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    try:
        proc = subprocess.Popen([sys.executable, "-m", __name__, str(child.fileno())],
                                pass_fds=(child.fileno(),), env=env)
    finally:
        child.close()
    ctl = Connection(parent.detach())
    ctl.send((target, tuple(args)))
    return proc, ctl


def _main() -> None:
    ctl = Connection(int(sys.argv[1]))
    target, args = ctl.recv()
    module, _, func = target.partition(":")
    getattr(importlib.import_module(module), func)(*args, ctl)


if __name__ == "__main__":
    _main()
