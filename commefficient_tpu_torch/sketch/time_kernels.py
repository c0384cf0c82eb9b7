"""Time the CUDA sketch kernels on one GPU, against other builds of them.

    python3 -m commefficient_tpu_torch.sketch.time_kernels \\
        [--lib LABEL=SOURCE.cu] ... [--iters N] [--turns N]

The checkout's kernels are always timed, labelled "this"; each ``--lib``
adds a library built from SOURCE with the kernels' nvcc flags (another
version of ``csrc/sketch_kernels.cu``, such as an older one, with the same C
interface). Each library is first held against the plain
PyTorch versions at the ResNet-9 slice's shapes (``torch.equal``; a build
that disagrees is still timed, and the script then exits with 1). Then each
kernel of each library is timed cold (L2 flushed before each launch) and
warm (the input rewritten just before each launch, as a round finds it), in
turns A B .. B A, repeated ``--turns`` times. Prints the card's name and
power limit, each build's ptxas registers and spills, and one JSON line per
library with the median over turns of each turn's median (and the turns).
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from . import _build, csvec, kernels

SLICE = (6_573_130, 524_288, 5)  # (d, c, r) of FetchSGD on ResNet-9
FLUSH_FLOATS = 64 * 2**20  # 256 MB, five times the 50 MB L2
SPIN_CYCLES = 200_000  # about 0.1 ms of device time ahead of each timed launch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, before) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each timed by a
    pair of CUDA events. ``before()`` runs ahead of each launch, outside the
    events (an L2 flush, or a rewrite of the input); a spin kernel then keeps
    the stream busy while the host records the start event and launches, so
    the events time the device work alone."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        before()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def ptxas_summary(log: str) -> str:
    """One line from nvcc's ``-Xptxas -v`` report: registers and spill
    stores of each kernel entry (accumulate, query<r>)."""
    out, name = [], "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            q = re.search(r"query_\w*ILi(\d+)E", entry.group(1))
            name = f"query<{q.group(1)}>" if q else (
                "accumulate" if "accumulate" in entry.group(1) else entry.group(1)[:32])
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            out.append([name, None, int(spill.group(1))])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out:
            out[-1][1] = int(regs.group(1))
    return "; ".join(f"{n} {r} regs {s} B spilled" for n, r, s in out)


def _launcher(lib, entry: str, inp: torch.Tensor, shifts: torch.Tensor, ks: torch.Tensor,
              out: torch.Tensor, d: int, c: int, r: int):
    """A closure that launches ``entry`` of ``lib`` into ``out``."""
    fn = getattr(lib, entry)
    args = (inp.data_ptr(), shifts.data_ptr(), ks.data_ptr(), out.data_ptr(),
            d, c, r, shifts.shape[1])

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    return launch


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", action="append", default=[],
                    help="LABEL=SOURCE.cu: another build to time")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    print(f"card: {card_line()}", flush=True)

    builds = [("this", _build.SOURCE)]
    for spec in args.lib:
        label, _, source = spec.partition("=")
        builds.append((label, Path(source).resolve()))
    libs = {}
    for label, source in builds:
        so, log = _build.compile_library(source)
        libs[label] = _build.bind(so)
        print(f"{label}: {source.name}  ptxas: {ptxas_summary(log)}", flush=True)

    d, c, r = SLICE
    dev = torch.device("cuda")
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=42, family="rotation")
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(d, generator=gen, device=dev)
    shifts, ks = csvec._rotation_keys(spec, v.device)
    table = csvec._sketch_vec_rotation(spec, v)
    want = {"sketch_accumulate": table, "sketch_query": csvec._query_all_rotation(spec, table)}
    inputs = {"sketch_accumulate": v, "sketch_query": table}
    outs = {"sketch_accumulate": torch.empty((r, c), device=dev),
            "sketch_query": torch.empty(d, device=dev)}
    launch = {(label, name): _launcher(lib, name, inputs[name], shifts, ks, outs[name], d, c, r)
              for label, lib in libs.items() for name in kernels.launch_counts}
    wrong = []
    for (label, name), fn in launch.items():
        outs[name].fill_(float("nan"))
        fn()
        torch.cuda.synchronize()
        if not torch.equal(outs[name], want[name]):
            wrong.append(f"{label} {name}")
    print(f"builds == plain at d={d} c={c} r={r}, except: {wrong or 'none'}", flush=True)

    flush = torch.ones(FLUSH_FLOATS, device=dev)
    modes = {"cold": lambda name: flush.sum(),
             "warm": lambda name: inputs[name].mul_(1.0)}
    order = list(libs) + list(reversed(libs))
    turns = {key: {m: [] for m in modes} for key in launch}
    for _ in range(args.turns):
        for label in order:
            for name in kernels.launch_counts:
                for mode, before in modes.items():
                    turns[(label, name)][mode].append(time_ms(
                        launch[(label, name)], args.iters, functools.partial(before, name)))
    for label, source in builds:
        row = {"lib": label, "source": str(source)}
        for name in kernels.launch_counts:
            t = turns[(label, name)]
            row[name] = {f"{m}_ms": statistics.median(t[m]) for m in modes}
            row[name].update({f"{m}_turns": t[m] for m in modes})
        print(json.dumps(row), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    raise SystemExit(main())
