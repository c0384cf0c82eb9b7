"""Reading a profiler capture: busy time as the union of device activity,
the idle gaps, and kernels attributed to the range their launch fell in;
and the per-layer readers on top of it."""

import json
import types

import pytest

from perfbench import counts, devtrace, harness
from perfbench.harness import SKETCH_RANGES

from . import tiny


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.t0", "tid": 1, "ts": 100,
         "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": SKETCH_RANGES[0], "tid": 1, "ts": 200,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 210,
         "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 300,
         "dur": 5, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 2, "ts": 220,
         "dur": 5, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "accumulate_tiles", "tid": 9, "ts": 260, "dur": 40,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32", "tid": 9, "ts": 320, "dur": 30,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_add", "tid": 9, "ts": 340, "dur": 20,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "tid": 9, "ts": 500, "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_read_attributes_unions_and_gaps(tmp_path):
    path = _trace(tmp_path)
    t0 = devtrace.marker_ts(path, "perfbench.t0")
    s = devtrace.read(path, SKETCH_RANGES, t0, t0 + 500)
    assert s.window_us == 500
    # [260, 300) + [320, 360) + [500, 510): the add overlaps the GEMM
    assert s.busy_us == 40 + 40 + 10
    assert sorted(s.gaps) == [(100, 160), (300, 20), (360, 140), (510, 90)]
    rng = {name: r for name, _, _, r in s.kernels}
    # launched inside the range on its thread; the other thread's launch
    # at 220 is outside any range of its own
    assert rng == {"accumulate_tiles": SKETCH_RANGES[0], "sm90_xmma_gemm_f32": "",
                   "elementwise_add": ""}
    assert devtrace.is_gemm("sm90_xmma_gemm_f32") and not devtrace.is_gemm("elementwise_add")


def test_readers_from_a_trace(tmp_path):
    path = _trace(tmp_path)
    t0 = devtrace.marker_ts(path, "perfbench.t0")
    s = devtrace.read(path, SKETCH_RANGES, t0, t0 + 500)
    root = tiny.make_root(str(tmp_path / "root"))
    cell = harness.load_cell(root, "tiny-gpt2-sketch")
    ctx = types.SimpleNamespace(traced={"summary": s, "rounds": 2}, sketch_dims=(1000, 5, 100),
                                window={"rounds": 4, "seconds": 2.0, "stats": None},
                                round_flops=1e12)
    read = {m["name"]: harness.load_metric(cell, m["name"]) for m in cell.bench["per_layer"]}
    assert read["device.idle_share"](ctx) == pytest.approx(100 * (1 - 90 / 500))
    assert read["kernels.gemm_ms"](ctx) == pytest.approx(30 / 1e3 / 2)
    assert read["kernels.other_ms"](ctx) == pytest.approx(20 / 1e3 / 2)
    assert read["device.step_mfu"](ctx) == pytest.approx(
        100 * 4e12 / 2.0 / counts.H100_FP32_FLOPS)
    acc = read["sketch.accumulate_roofline"](ctx)
    assert acc == pytest.approx(counts.roofline_share(4 * 1000 + 4 * 500, 40e-6 / 2))
    # no kernel ran inside the query's range: nothing to read, not 0
    assert read["sketch.query_roofline"](ctx) is None
    ctx.sketch_dims = None
    assert read["sketch.accumulate_roofline"](ctx) is None
