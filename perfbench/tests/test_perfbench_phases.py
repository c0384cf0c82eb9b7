"""The phase reader (``perfbench/phases.py``) on a synthetic capture: each
kernel attributed to the innermost program range around its launch, the
round step's self time outside its children, the device's idle intervals
split by their overlap with the runner's ranges, the two ``device.idle_*``
readers, and ``devtrace.read`` unmoved by the mirrored ranges."""

import json
import types

import pytest

from perfbench import devtrace, harness, phases
from perfbench.harness import SKETCH_RANGES

from . import tiny

MAIN, OTHER, AUTOGRAD, STREAM = 1, 2, 3, 7


def _range(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts, "dur": dur}


def _kernel(name, launch_ts, ts, dur, corr, tid=MAIN, stream=STREAM):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
             "ts": launch_ts, "dur": 2, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "tid": stream, "ts": ts, "dur": dur,
             "args": {"correlation": corr}}]


def _events(mirrored: bool = True) -> list:
    """One round over [100, 1000): prepare, then a dispatch holding
    round.step, which holds round.client (a GEMM and an add), a kernel of
    its own, round.server holding sketch.query and a nested sketch.topk,
    then the drain and commit; the device idles across them."""
    ev = [_range("perfbench.t0", 100, 1), _range(SKETCH_RANGES[1], 505, 20)]
    if mirrored:
        ev += [_range("prepare", 100, 50), _range("dispatch", 150, 600),
               _range("round.step", 160, 580), _range("round.client", 170, 200),
               _range("round.server", 500, 200), _range("sketch.query", 505, 20),
               _range("sketch.topk", 600, 50), _range("sketch.topk", 610, 20),
               _range("drain", 760, 150), _range("commit", 910, 60),
               # another thread's ranges never hold this thread's launches
               _range("round.client", 150, 800, tid=OTHER)]
    ev += _kernel("sm90_xmma_gemm_f32", 180, 200, 100, 1)  # round.client, GEMM
    ev += _kernel("elementwise_add", 190, 300, 50, 2)  # round.client
    ev += _kernel("reduce_kernel", 400, 400, 30, 3)  # round.step's own
    ev += _kernel("query_tiles", 510, 520, 10, 4)  # sketch.query
    ev += _kernel("radix_sort", 605, 600, 40, 5)  # sketch.topk, the outer
    ev += _kernel("gather", 615, 640, 20, 6)  # sketch.topk, the inner
    ev += _kernel("index_put", 680, 660, 20, 7)  # round.server's own
    ev += _kernel("copy_kernel", 940, 980, 10, 8)  # commit: no round range
    ev += _kernel("loader_kernel", 200, 700, 10, 9, tid=OTHER)  # another thread
    # the autograd engine's worker launches the backward while the main
    # thread waits in round.client (a thread that holds no range of its own)
    ev.append({"ph": "M", "name": "thread_name", "tid": AUTOGRAD,
               "args": {"name": "thread 3 (pt_autograd_0)"}})
    ev += _kernel("wgrad_kernel", 360, 360, 40, 11, tid=AUTOGRAD)
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "tid": STREAM,
               "ts": 900, "dur": 20})
    return ev


def _write(tmp_path, events, name="t.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_kernels_go_to_the_innermost_range_on_their_thread(tmp_path):
    path = _write(tmp_path, _events())
    t0 = devtrace.marker_ts(path, "perfbench.t0")
    ph = phases.read(path, t0, t0 + 900)
    assert ph.kernel_us == pytest.approx({
        # the GEMM, the add, the other thread's launch in its own range, and
        # the autograd engine's gradient kernel
        "round.client": 150 + 10 + 40,
        "round.step": 30, "sketch.query": 10, "sketch.topk": 60, "round.server": 20,
        "commit": 10})
    assert ph.gemm_us == {"round.client": 100 + 40}
    assert ph.autograd_us == 40
    assert ph.topk_us == 60  # both the outer and the nested range's kernels
    assert ph.streams == {STREAM: 330}
    r = phases.readings(ph, rounds=2)
    assert r["round.client_ms"] == pytest.approx(200 / 1e3 / 2)
    # the round step's self time and the server step's, outside the leaves
    assert r["round.server_ms"] == pytest.approx(50 / 1e3 / 2)
    assert r["sketch.topk_ms"] == pytest.approx(60 / 1e3 / 2)
    assert r["outside_round_ms"] == pytest.approx(10 / 1e3 / 2)
    assert r["other_by_range_ms"]["round.client"] == pytest.approx(60 / 1e3 / 2)
    assert r["autograd_thread_ms"] == pytest.approx(40 / 1e3 / 2)


def test_a_launch_outside_every_range_has_none(tmp_path):
    ev = _events() + _kernel("stray", 990, 995, 3, 10)
    path = _write(tmp_path, ev)
    ph = phases.read(path, 100, 1000)
    assert ph.kernel_us[""] == 3


def test_idle_splits_by_overlap_across_drain_commit_and_dispatch(tmp_path):
    path = _write(tmp_path, _events())
    ph = phases.read(path, 100, 1000)
    # busy: [200, 350) [360, 430) [520, 530) [600, 680) [700, 710)
    # [900, 920) [980, 990); idle: the rest of [100, 1000)
    assert ph.busy_us == 150 + 70 + 10 + 80 + 10 + 20 + 10
    idle = ph.idle_us
    assert idle["prepare"] == 50  # [100, 150)
    # [150, 200), [350, 360), [430, 520), [530, 600), [680, 700), [710, 750)
    assert idle["dispatch"] == 50 + 10 + 90 + 70 + 20 + 40
    assert idle["drain"] == 150 - 10  # [760, 910) but the copy's [900, 910)
    assert idle["commit"] == 60 - 10  # [910, 970) but the copy's [910, 920)
    assert sum(idle.values()) == pytest.approx(900 - ph.busy_us)
    assert idle[""] == 10 + 10 + 10  # [750, 760), [970, 980), [990, 1000)
    r = phases.readings(ph, rounds=1)
    assert r["device.idle_drain_ms"] == pytest.approx((140 + 50) / 1e3)
    assert r["idle_ms"] == pytest.approx((900 - ph.busy_us) / 1e3)


def test_split_idle_counts_each_overlap_once():
    gaps = [(0, 10), (20, 10)]
    got = phases.split_idle(gaps, {"dispatch": [(5, 25)], "drain": [(25, 40)]})
    assert got == {"dispatch": 5 + 5, "drain": 5, "": 5}


def test_devtrace_read_is_unmoved_by_the_mirrored_ranges(tmp_path):
    plain = _write(tmp_path, _events(mirrored=False), "plain.json")
    mirrored = _write(tmp_path, _events(), "mirrored.json")
    a = devtrace.read(plain, SKETCH_RANGES, 100, 1000)
    b = devtrace.read(mirrored, SKETCH_RANGES, 100, 1000)
    assert a == b
    assert {r for _, _, _, r in a.kernels} == {"", SKETCH_RANGES[1]}


def _traced(tmp_path, rounds=2):
    """The harness's traced dict for the synthetic capture: its summary,
    and the runner spans on the tracer's clock (the trace's less 1,000 us)."""
    path = _write(tmp_path, _events())
    summary = devtrace.read(path, SKETCH_RANGES, 100, 1000)
    spans = [{"cat": "runner", "ph": "X", "name": e["name"], "ts": e["ts"] - 1000,
              "dur": e["dur"]} for e in _events()
             if e.get("cat") == "user_annotation" and e["name"] in phases.RUNNER]
    return {"summary": summary, "rounds": rounds, "spans": spans, "offset_us": 1000.0}


def test_idle_readers_from_the_harness_traced_stretch(tmp_path):
    traced = _traced(tmp_path)
    root = tiny.make_root(str(tmp_path / "root"))
    cell = harness.load_cell(root, "tiny-gpt2-sketch")
    ctx = types.SimpleNamespace(traced=traced)
    dispatch = harness.load_metric(cell, "device.idle_dispatch_ms")(ctx)
    drain = harness.load_metric(cell, "device.idle_drain_ms")(ctx)
    assert dispatch == pytest.approx(280 / 1e3 / 2)
    assert drain == pytest.approx(190 / 1e3 / 2)
    s = traced["summary"]
    assert dispatch + drain <= (s.window_us - s.busy_us) / 1e3 / 2
    # nothing traced, no runner spans, or no device activity: nothing to read
    ctx.traced = None
    assert harness.load_metric(cell, "device.idle_drain_ms")(ctx) is None
    ctx.traced = dict(traced, spans=[])
    assert harness.load_metric(cell, "device.idle_drain_ms")(ctx) is None
    ctx.traced = dict(traced, summary=devtrace.Summary(900, 0.0, [], [], {}, 100))
    assert harness.load_metric(cell, "device.idle_dispatch_ms")(ctx) is None
