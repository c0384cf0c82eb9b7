"""Seconds from the process's start to the window's first round: imports,
data and weights from the seed, the session, the checked and warm-up
rounds (and, in a checkout's first run, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
