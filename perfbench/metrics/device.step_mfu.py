"""% of the H100's float32 peak (67 TFLOP/s, outside the tensor cores:
TF32 is off) that the timed window's rounds reach, counting the model
FLOPs of every round from shapes (``perfbench/counts.py``)."""

from perfbench import counts


def read(ctx):
    w = ctx.window
    if not w["rounds"] or w["seconds"] <= 0:
        return None
    return 100.0 * ctx.round_flops * w["rounds"] / w["seconds"] / counts.H100_FP32_FLOPS
