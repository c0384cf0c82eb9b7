"""LR schedules, copied from the JAX package's ``utils/schedules.py`` (SURVEY.md L0c: `PiecewiseLinear` — 0 -> peak at pivot_epoch
-> 0 over num_epochs, the cifar10-fast triangular schedule)."""

from __future__ import annotations


class PiecewiseLinear:
    """Linear interpolation through (knot, value) pairs; flat beyond the ends.

    The reference's triangular schedule is
    `PiecewiseLinear([0, pivot_epoch, num_epochs], [0, lr_scale, 0])`,
    evaluated at fractional epochs.
    """

    def __init__(self, knots: list[float], values: list[float]) -> None:
        if len(knots) != len(values) or len(knots) < 2:
            raise ValueError("need >= 2 matching knots/values")
        if any(b <= a for a, b in zip(knots, knots[1:])):
            raise ValueError("knots must be strictly increasing")
        self.knots = list(map(float, knots))
        self.values = list(map(float, values))

    def __call__(self, t: float) -> float:
        ks, vs = self.knots, self.values
        if t <= ks[0]:
            return vs[0]
        if t >= ks[-1]:
            return vs[-1]
        for i in range(len(ks) - 1):
            if t <= ks[i + 1]:
                frac = (t - ks[i]) / (ks[i + 1] - ks[i])
                return vs[i] + frac * (vs[i + 1] - vs[i])
        return vs[-1]


def triangular(lr_scale: float, pivot_epoch: float, num_epochs: float) -> PiecewiseLinear:
    return PiecewiseLinear([0.0, pivot_epoch, max(num_epochs, pivot_epoch + 1e-6)],
                           [0.0, lr_scale, 0.0])
