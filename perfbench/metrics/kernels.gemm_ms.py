"""Device ms a round in matrix-product and convolution kernels (by kernel
name, ``perfbench/devtrace.py``), outside the sketch's ranges, over the
traced stretch."""

from perfbench import devtrace


def read(ctx):
    t = ctx.traced
    if t is None or not t["rounds"]:
        return None
    us = sum(dur for name, _, dur, rng in t["summary"].kernels
             if not rng and devtrace.is_gemm(name))
    return us / 1e3 / t["rounds"] if us > 0 else None
