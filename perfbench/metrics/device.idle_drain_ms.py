"""Device-idle ms a round of the traced stretch while the run loop's main
thread was inside ``drain`` or ``commit`` (the sync bubble): the overlap of
the device's idle intervals with the runner's drain and commit spans
(``perfbench/phases.py``)."""

from perfbench import phases


def read(ctx):
    return phases.idle_ms_per_round(ctx.traced, ("drain", "commit"))
