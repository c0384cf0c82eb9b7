"""The 90th percentile (nearest rank), over the window's rounds, of the
time from one round's end on the device to the next's (a CUDA event
recorded after each dispatch)."""


def read(ctx):
    v = sorted(ctx.window["round_ms"])
    return v[max(0, -(-9 * len(v) // 10) - 1)] if v else None
