"""Device-idle ms a round of the traced stretch while the run loop's main
thread was inside ``dispatch`` (launch-bound idle): the overlap of the
device's idle intervals with the runner's dispatch spans
(``perfbench/phases.py``)."""

from perfbench import phases


def read(ctx):
    return phases.idle_ms_per_round(ctx.traced, ("dispatch",))
