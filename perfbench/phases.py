"""The round's phases in a traced stretch: the device time of the kernels
each phase of the program launched, and the device's idle time split by
the run loop's phase on its main thread.

The port's tracer mirrors its spans into an open ``torch.profiler``
capture as ``record_function`` ranges of the same names
(``commefficient_tpu_torch/obs/trace.py``): the runner's ``prepare``,
``dispatch``, ``drain`` and ``commit``, and inside the round step
``round.step``, ``round.client``, ``round.server`` and the sketch leaves
``sketch.accumulate``, ``sketch.query`` and ``sketch.topk``
(``federated/engine.py``). So the capture holds the phases and the kernels
on one clock. ``read`` attributes each kernel to the innermost of those
ranges that encloses its launch on the launching thread (the runtime event
with the kernel's ``correlation`` id, as ``devtrace.read`` matches them),
and splits each idle interval of the device by its overlap with the
runner's ranges on the thread that dispatches. One thread launches for
another: PyTorch's autograd engine runs every backward pass on a worker
thread of its own (``pt_autograd_<device>``) while the calling thread
waits inside its range, so a launch there takes the innermost range open
at that moment on the thread that dispatches (about 60 % of the client
phase's kernels: the gradients).

``idle_ms_per_round`` reads the same split from what the harness's traced
stretch already returns (its runner spans, put on the trace's clock by
``offset_us``): the two ``device.idle_*`` metrics read it.

    python3 -m perfbench.phases --workload <cell> --seed <n> [--seed ...] --seconds <s>

from the root of a checkout, on a card, runs the cell's set-up, timed
windows in turns with the tracer disarmed, armed, armed, disarmed
(``--turns`` times; no capture open: what arming costs), then a traced
stretch as the harness
makes it, and prints one JSON line per seed: the windows' updates/s and
the stretch's phase readings beside the harness's kernel and idle
readings of the same capture.
"""

from __future__ import annotations

import collections
import dataclasses
import json

from . import devtrace

RUNNER = ("prepare", "dispatch", "drain", "commit")
ROUND = ("round.step", "round.client", "round.server")
SKETCH = ("sketch.accumulate", "sketch.query", "sketch.topk")
PROGRAM = RUNNER + ROUND + SKETCH


@dataclasses.dataclass
class Phases:
    window_us: float
    busy_us: float
    kernel_us: dict  # innermost program range ("" none) -> kernel us
    gemm_us: dict  # the same, matrix-product and convolution kernels only
    autograd_us: float  # kernel us launched by the autograd engine's threads
    topk_us: float  # kernel us launched anywhere inside sketch.topk
    idle_us: dict  # runner range of the main thread ("" none) -> idle us
    streams: dict  # the device's stream (its trace row) -> kernel us


def _overlap(a: list, b: list) -> float:
    """Total length of the intersection of two lists of disjoint [start,
    end) intervals, each sorted by start."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def split_idle(gaps: list, ranges: dict) -> dict:
    """Idle us by the range the main thread was in: ``gaps`` (start, dur)
    of the device's idle intervals, ``ranges`` name -> [(start, end)] of
    disjoint ranges; "" holds what no range covers."""
    idle = sorted((s, s + d) for s, d in gaps)
    out = {name: _overlap(idle, sorted(iv)) for name, iv in ranges.items()}
    out[""] = sum(e - s for s, e in idle) - sum(out.values())
    return out


def read(path: str, t_start_us: float, t_end_us: float) -> Phases:
    """The phase readings of the capture at ``path`` between two
    timestamps of the trace's clock (``devtrace.marker_ts``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = collections.defaultdict(list)  # tid -> [(start, end, name)]
    launches = {}  # correlation id -> (tid, ts)
    device, autograd = [], set()
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name" and \
                "pt_autograd" in ev.get("args", {}).get("name", ""):
            autograd.add(ev["tid"])
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev.get("name") in PROGRAM:
            ranges[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["tid"], ev["ts"])
        elif cat in devtrace.DEVICE_CATS:
            device.append(ev)

    # the main thread: the one that dispatches
    main = max(ranges, key=lambda t: sum(r[2] == "dispatch" for r in ranges[t]), default=None)
    # each launch's open ranges on its thread (the main thread's for the
    # autograd engine's), by a sweep in time order: the ranges nest, so
    # the open ones form a stack
    at_launch = {}  # correlation id -> names of the open ranges, outermost first
    by_tid = collections.defaultdict(list)
    for corr, (tid, ts) in launches.items():
        by_tid[tid].append((ts, corr))
    for tid, calls in by_tid.items():
        own = main if tid in autograd and tid not in ranges else tid
        todo = sorted(ranges.get(own, ()), key=lambda r: (r[0], -r[1]))
        stack, i = [], 0
        for ts, corr in sorted(calls):
            while i < len(todo) and todo[i][0] <= ts:
                while stack and stack[-1][1] < todo[i][0]:
                    stack.pop()
                stack.append(todo[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            at_launch[corr] = [r[2] for r in stack]

    kernel_us, gemm_us = collections.defaultdict(float), collections.defaultdict(float)
    streams = collections.defaultdict(float)
    topk_us, autograd_us, intervals = 0.0, 0.0, []
    for ev in device:
        s, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if s + dur < t_start_us or s > t_end_us:
            continue
        s0, e0 = max(s, t_start_us), min(s + dur, t_end_us)
        intervals.append((s0, e0))
        if ev["cat"] != "kernel":
            continue
        open_ranges = at_launch.get(ev.get("args", {}).get("correlation"), [])
        inner = open_ranges[-1] if open_ranges else ""
        kernel_us[inner] += e0 - s0
        if devtrace.is_gemm(ev["name"]):
            gemm_us[inner] += e0 - s0
        if "sketch.topk" in open_ranges:
            topk_us += e0 - s0
        if launches.get(ev.get("args", {}).get("correlation"), (None,))[0] in autograd:
            autograd_us += e0 - s0
        streams[ev.get("tid")] += e0 - s0
    busy, gaps = devtrace._union(intervals)
    if intervals:
        first, last = min(s for s, _ in intervals), max(e for _, e in intervals)
        gaps = ([(t_start_us, first - t_start_us)] if first > t_start_us else []) + gaps + (
            [(last, t_end_us - last)] if last < t_end_us else [])
    runner = {name: [(s, e) for s, e, n in ranges.get(main, ()) if n == name] for name in RUNNER}
    return Phases(window_us=t_end_us - t_start_us, busy_us=busy, kernel_us=dict(kernel_us),
                  gemm_us=dict(gemm_us), autograd_us=autograd_us, topk_us=topk_us,
                  idle_us=split_idle(gaps, runner), streams=dict(streams))


def readings(ph: Phases, rounds: int) -> dict:
    """The per-round readings of ``read``'s result: the round's phases'
    kernel ms, the top-k's, the rest (kernels launched in no ``round.*``
    or ``sketch.*`` range) and the idle ms by the runner's range."""
    def ms(us):
        return us / 1e3 / rounds

    k = ph.kernel_us
    in_round = set(ROUND + SKETCH)
    return {
        "round.client_ms": ms(k.get("round.client", 0.0)),
        "round.server_ms": ms(k.get("round.step", 0.0) + k.get("round.server", 0.0)),
        "sketch.topk_ms": ms(ph.topk_us),
        "sketch.accumulate_ms": ms(k.get("sketch.accumulate", 0.0)),
        "sketch.query_ms": ms(k.get("sketch.query", 0.0)),
        "outside_round_ms": ms(sum(v for n, v in k.items() if n not in in_round)),
        "autograd_thread_ms": ms(ph.autograd_us),
        "device.idle_dispatch_ms": ms(ph.idle_us.get("dispatch", 0.0)),
        "device.idle_drain_ms": ms(ph.idle_us.get("drain", 0.0) + ph.idle_us.get("commit", 0.0)),
        "idle_prepare_ms": ms(ph.idle_us.get("prepare", 0.0)),
        "idle_outside_ms": ms(ph.idle_us.get("", 0.0)),
        "idle_ms": ms(ph.window_us - ph.busy_us),
        "kernels_by_range_ms": {n or "none": ms(v) for n, v in sorted(k.items())},
        "other_by_range_ms": {n or "none": ms(v - ph.gemm_us.get(n, 0.0))
                              for n, v in sorted(k.items())},
        "streams_ms": {str(s): ms(v) for s, v in sorted(ph.streams.items(), key=str)},
    }


def idle_ms_per_round(traced: dict | None, names: tuple) -> float | None:
    """Device-idle ms a round of the harness's traced stretch while the
    run loop was inside one of the runner spans ``names`` (the tracer's
    spans, put on the trace's clock by ``offset_us``); None without a
    traced stretch, runner spans or device activity."""
    if traced is None or not traced["rounds"] or not traced["spans"]:
        return None
    s = traced["summary"]
    if s.busy_us <= 0:
        return None
    off = traced["offset_us"]
    ranges = {name: [(e["ts"] + off, e["ts"] + e["dur"] + off) for e in traced["spans"]
                     if e["name"] == name] for name in names}
    idle = split_idle(s.gaps, ranges)
    return sum(idle[n] for n in names) / 1e3 / traced["rounds"]


# -- the measurement: arming's cost and the phases of a traced stretch --------

def stretch(run, path: str) -> dict:
    """``harness.traced_stretch``'s stretch (the harness's sketch ranges
    and start marker included), keeping the capture at ``path``: the
    harness's summary of it, the phase readings, and the host ms a round
    of the tracer's ``round.client`` spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from commefficient_tpu_torch.obs import trace as obtrace

    from . import harness

    n = run.cell.workload["trace_rounds"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda"
                                     else [])
    prof = profile(activities=acts)
    marks: dict = {}
    tracer = obtrace.get()

    def on_committed(rnd, cfg):
        if "open" not in marks:
            prof.start()
            with torch.profiler.record_function(harness.MARKER):
                marks["open"] = (rnd, tracer.now_us())
        elif rnd >= marks["open"][0] + n:
            marks["close"] = (rnd, tracer.now_us())
            prof.stop()
            cfg.total_rounds = rnd

    obtrace.configure(trace_path=path + ".spans")  # in memory; never flushed
    try:
        with harness._sketch_ranges():
            harness._loop(run, harness.NEVER, on_committed=on_committed)
        events = tracer.events()
    finally:
        obtrace.configure()
    prof.export_chrome_trace(path)
    (r0, host0), (r1, host1) = marks["open"], marks["close"]
    t_mark = devtrace.marker_ts(path, harness.MARKER)
    t_end = t_mark + (host1 - host0)
    rounds = r1 - r0
    runner = [e for e in events if e.get("cat") == "runner" and e.get("ph") == "X"]
    traced = {"summary": devtrace.read(path, harness.SKETCH_RANGES, t_mark, t_end),
              "rounds": rounds, "spans": runner, "offset_us": t_mark - host0}
    client_host = sum(e["dur"] for e in events
                      if e.get("cat") == "federated" and e.get("name") == "round.client"
                      and host0 <= e["ts"] and e["ts"] + e["dur"] <= host1)
    device = [e["dur"] for e in events if e.get("cat") == "device"
              and host0 <= e["ts"] and e["ts"] + e["dur"] <= host1]
    return {"traced": traced, "phases": read(path, t_mark, t_end),
            "client_host_ms": client_host / 1e3 / rounds,
            "device_span_ms": [d / 1e3 for d in device]}


def measure(root: str, name: str, seed: int, seconds: float, path: str,
            turns: int = 1) -> dict:
    """One seed of a cell: its set-up, the timed windows in turns
    disarmed, armed, armed, disarmed, then ``stretch``'s readings beside
    the harness's kernel and idle readings of the same capture."""
    import time

    import torch

    from commefficient_tpu_torch.obs import trace as obtrace

    from . import harness

    t0 = time.perf_counter()
    cell = harness.load_cell(root, name)
    run = harness.build(cell, seed)
    w = cell.workload
    harness._loop(run, run.session.round + w["checked_rounds"] + w["warmup_rounds"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    windows = []
    for armed in (False, True, True, False) * turns:
        if armed:
            obtrace.configure(trace_path=path + ".armed")  # in memory; never flushed
        try:
            win = harness.window(run, seconds)
        finally:
            obtrace.configure()
        windows.append({"armed": armed, "rounds": win["rounds"], "seconds": win["seconds"],
                        "updates_per_s": run.W * win["rounds"] / win["seconds"]})
    st = stretch(run, path)
    s, tr = st["traced"]["summary"], st["traced"]
    kernels = {"gemm": sum(d for n, _, d, r in s.kernels if not r and devtrace.is_gemm(n)),
               "other": sum(d for n, _, d, r in s.kernels if not r and not devtrace.is_gemm(n))}
    return {"workload": name, "seed": seed, "device": torch.cuda.get_device_name(0),
            "setup_s": setup_s, "windows": windows,
            "rounds": tr["rounds"],
            "kernels.gemm_ms": kernels["gemm"] / 1e3 / tr["rounds"],
            "kernels.other_ms": kernels["other"] / 1e3 / tr["rounds"],
            "device.idle_share": 100.0 * (1.0 - s.busy_us / s.window_us),
            "round.client_host_ms": st["client_host_ms"],
            "device_span_ms": st["device_span_ms"],
            "idle_dispatch_ms_from_spans": idle_ms_per_round(tr, ("dispatch",)),
            "idle_drain_ms_from_spans": idle_ms_per_round(tr, ("drain", "commit")),
            **readings(st["phases"], tr["rounds"])}


def main(argv=None) -> int:
    import argparse
    import os
    import sys

    p = argparse.ArgumentParser(description="arming's cost and a traced stretch's phases")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--turns", type=int, default=1,
                   help="disarmed, armed, armed, disarmed windows, this many times")
    p.add_argument("--keep", default="", help="directory to keep each capture in")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.phases measures on a CUDA device; none is available", file=sys.stderr)
        return 3
    root = os.getcwd()
    out_dir = args.keep or os.path.join(root, "build", "perfbench")
    os.makedirs(out_dir, exist_ok=True)
    for seed in args.seed:
        path = os.path.join(out_dir, f"phases-{args.workload}-{seed}.json")
        out = measure(root, args.workload, seed, args.seconds, path, args.turns)
        if not args.keep:
            os.remove(path)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
