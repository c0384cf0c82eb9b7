"""Host ms a round the run loop waited for a prepared round (cohort
sampling and batch assembly on the prefetch thread): ``RunStats.prepare_ms``
over the timed window's rounds."""


def read(ctx):
    w = ctx.window
    return w["stats"].prepare_ms / w["rounds"] if w["rounds"] else None
