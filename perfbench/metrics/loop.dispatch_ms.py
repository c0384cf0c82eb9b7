"""Host ms a round spent launching the round's work: the run loop's
``RunStats.dispatch_ms`` over the timed window's rounds."""


def read(ctx):
    w = ctx.window
    return w["stats"].dispatch_ms / w["rounds"] if w["rounds"] else None
