"""Reading a ``torch.profiler`` capture (its Chrome-trace export): the
device's busy time, its idle gaps, the time of each kernel, and the
kernels launched inside the benchmark's own ``record_function`` ranges.

A kernel belongs to a range when the host call that launched it (the
runtime event with the same ``correlation`` id) started inside that range
on the same host thread.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    window_us: float  # the capture's host-clock length
    busy_us: float  # union of the device's activity
    kernels: list  # (name, start_us, dur_us, range name or "")
    gaps: list  # (start_us, dur_us) of the device's idle gaps
    device_ops: dict  # name -> total us, every device activity
    t0_us: float  # the capture's first host timestamp, in the trace's clock


def _union(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """Total length and the gaps between merged [start, end) intervals."""
    busy, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s - cur[1]))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def read(path: str, ranges: tuple[str, ...], t_start_us: float, t_end_us: float) -> Summary:
    """Summarise the capture at ``path`` between the two host timestamps
    (the trace's own clock; see ``marker_ts``), with the kernels of the
    named ``record_function`` ranges attributed to them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = collections.defaultdict(list)  # tid -> [(start, end, name)]
    launches = {}  # correlation id -> (tid, ts)
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev.get("name") in ranges:
            spans[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["tid"], ev["ts"])
        elif cat in DEVICE_CATS:
            device.append(ev)
    for v in spans.values():
        v.sort()
    starts = {tid: [s for s, _, _ in v] for tid, v in spans.items()}

    def range_of(corr) -> str:
        launch = launches.get(corr)
        if launch is None or launch[0] not in spans:
            return ""
        tid, ts = launch
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and spans[tid][i][0] <= ts <= spans[tid][i][1]:
            return spans[tid][i][2]
        return ""

    kernels, intervals, ops = [], [], collections.defaultdict(float)
    for ev in device:
        s, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if s + dur < t_start_us or s > t_end_us:
            continue
        s0, e0 = max(s, t_start_us), min(s + dur, t_end_us)
        intervals.append((s0, e0))
        ops[ev["name"]] += e0 - s0
        if ev["cat"] == "kernel":
            kernels.append((ev["name"], s0, e0 - s0,
                            range_of(ev.get("args", {}).get("correlation"))))
    busy, gaps = _union(intervals)
    if intervals:
        first, last = min(s for s, _ in intervals), max(e for _, e in intervals)
        gaps = ([(t_start_us, first - t_start_us)] if first > t_start_us else []) + gaps + (
            [(last, t_end_us - last)] if last < t_end_us else [])
    return Summary(window_us=t_end_us - t_start_us, busy_us=busy, kernels=kernels, gaps=gaps,
                   device_ops=dict(ops), t0_us=t_start_us)


def marker_ts(path: str, name: str) -> float | None:
    """The trace-clock start of the first ``record_function`` range named
    ``name``."""
    with open(path) as f:
        for ev in json.load(f)["traceEvents"]:
            if ev.get("cat") == "user_annotation" and ev.get("name") == name:
                return float(ev["ts"])
    return None


# Matrix-product and convolution kernels by name: cuBLAS and CUTLASS
# GEMMs ("gemm", "nvjet", "xmma", "cutlass") and cuDNN's convolutions and
# their gradient kernels.
_GEMM_TAGS = ("gemm", "nvjet", "xmma", "cutlass", "conv", "wgrad", "dgrad", "fprop")


def is_gemm(kernel_name: str) -> bool:
    name = kernel_name.lower()
    return any(tag in name for tag in _GEMM_TAGS)
