"""The readings each limit of a cell is set from, at the cell's own size:

- the program's: its checked rounds against the fp32 reference, on every
  seed given (the lower reading is their largest);
- the control's: the reference computed in TF32 (the nearest precision
  below the configuration's float32 with TF32 off) in the program's place,
  on the first ``--controls`` seeds (the upper reading is their smallest);
- a planted fault's: the reference over half of each cohort, the mean
  taken over the rest, in the program's place, on the same seeds.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 [--controls 3]

One JSON line a seed, then a summary line. It runs no timed window, so
several seeds share one process and its set-up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import check, harness
from .reference.fetchsgd import follow


def readings(cell, seed: int, controls: bool, device: str = "cuda") -> dict:
    t0 = time.perf_counter()
    run = harness.build(cell, seed, device)
    snaps = harness.checked_rounds(run)
    harness.free_program(run)
    ref = harness.reference_side(run)
    prog = harness.program_side(run, snaps, ref["p0"])
    mode = cell.workload["mode"]
    out = {"seed": seed, "program": check.numbers(cell.model_cfg, mode, prog, ref)}
    if controls:
        det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(False)
        try:
            for name, kw in (("control_tf32", {"prec": "tf32"}),
                             ("fault_half_batch", {"clients": "half"})):
                other = follow(cell.model_cfg, cell.model_cfg["fetchsgd"], mode, run.W,
                               run.session_seed, ref["p0"], run.data,
                               cell.workload["checked_rounds"], **kw)
                out[name] = check.numbers(cell.model_cfg, mode, other, ref)
        finally:
            torch.use_deterministic_algorithms(det)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=os.getcwd(), help="the directory holding BENCHMARK.json")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.root, args.workload)
    rows = []
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        rows.append(readings(cell, s, i < args.controls, args.device))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for key in ("loss_gap", "loss1_gap", "grad_gap", "change_gap", "change_median_gap"):
        summary[key] = {"program_max": max(r["program"][key] for r in rows)}
        for name in ("control_tf32", "fault_half_batch"):
            vals = [r[name][key] for r in rows if name in r]
            if vals:
                summary[key][f"{name}_min"] = min(vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
