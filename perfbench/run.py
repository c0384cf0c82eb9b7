"""The port's benchmark: one run of one cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's session from the seed,
runs its checked rounds and a warm-up (the set-up), then whole rounds for
``--seconds`` (the window), checks the checked rounds against the plain
reference, and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled stretch after the window. The numbers
the check compared, each beside its limit, end standard error and the
result line.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), when a file it needs is missing, and when
JAX, flax or the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
# every build and kernel cache of the program at a fixed path inside the
# checkout, so that only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)


def _card_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" when it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        print("--seed must be >= 0", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = next((w for w in json.load(f)["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3

    from perfbench import harness

    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           t_process=T_PROCESS)
    found = harness.jax_modules()
    if found:
        print(f"loaded by the time the window closed: {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": out["peak_bytes"], "power_limit": _card_limit()}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if args.trace:
        device["busy_s"], device["window_s"] = out["busy_s"], out["traced_window_s"]
        result["breakdown"] = out["breakdown"]
        print(f"traced: {out['traced_rounds']} rounds in {out['traced_window_s']} s, device busy "
              f"{out['busy_s']} s", file=sys.stderr)
    q = sorted(out["round_ms"])
    print(f"window: {out['window_rounds']} rounds in {out['window_s']} s; round ms min "
          f"{q[0]:.2f} p10 {q[len(q) // 10]:.2f} p50 {q[len(q) // 2]:.2f} max {q[-1]:.2f}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = out["checks"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
