"""Client updates committed in the timed window over its wall time (host
clock, from the window's start to its last drain)."""


def read(ctx):
    w = ctx.window
    return ctx.W * w["rounds"] / w["seconds"] if w["rounds"] else None
