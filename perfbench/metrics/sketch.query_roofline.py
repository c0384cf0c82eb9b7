"""% of the bandwidth bound that the device time of every kernel launched
inside the harness's range around the port's ``csvec.query_all`` (inside
``unsketch_topk``) reaches: (4 r c + 4 d bytes at 3.35 TB/s) over that
time, a round at a time."""

from perfbench import counts


def read(ctx):
    t = ctx.traced
    if t is None or ctx.sketch_dims is None:
        return None
    us = [dur for _, _, dur, rng in t["summary"].kernels if rng == "perfbench.query_all"]
    if not us or not t["rounds"]:
        return None
    per_round_s = sum(us) / 1e6 / t["rounds"]
    return counts.roofline_share(counts.sketch_bytes(*ctx.sketch_dims), per_round_s)
