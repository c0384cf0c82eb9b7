"""% of the traced stretch in which no kernel, copy or memset ran on the
device (the profiler's timeline)."""


def read(ctx):
    t = ctx.traced
    if t is None or t["summary"].window_us <= 0 or t["summary"].busy_us <= 0:
        return None
    s = t["summary"]
    return 100.0 * (1.0 - s.busy_us / s.window_us)
