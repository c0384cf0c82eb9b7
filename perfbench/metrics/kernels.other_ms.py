"""Device ms a round in every kernel that is neither a matrix product nor
a convolution, outside the sketch's ranges, over the traced stretch."""

from perfbench import devtrace


def read(ctx):
    t = ctx.traced
    if t is None or not t["rounds"]:
        return None
    us = sum(dur for name, _, dur, rng in t["summary"].kernels
             if not rng and not devtrace.is_gemm(name))
    return us / 1e3 / t["rounds"] if us > 0 else None
