"""O(1)-per-participant client state: splitmix64 host streams, no
tables (the port's copy of the JAX package's ``serve/clients.py``).

At a 10M-client population no per-client dict or array can exist on the
serving host, so every per-client property is a pure function of (seed,
client_id[, round]): ``fold_in_host`` is a vectorized splitmix64 fold of
those words, and ``uniform01``, the device classes and the response
latencies derive from it. The reference's ``client_key`` (a JAX PRNG
helper no serve path calls) is left out.

Device classes model the heterogeneous edge population: each class has
its own straggle distribution (lognormal response latency) and no-show
probability, and a client's class is a hash of its id.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# splitmix64 constants (Steele et al.) — a well-mixed 64-bit permutation is
# all a traffic stream needs; NOT a substitute for the engine's threefry
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix(z: np.ndarray) -> np.ndarray:
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def fold_in_host(seed: int, client_id, *extra) -> np.ndarray:
    """uint64 stream value for (seed, client_id, *extra) — the host-side
    fold_in: deterministic, order-sensitive, vectorized over `client_id`
    (scalar or ndarray), O(1) memory per call. Each fold is one splitmix64
    round over the running state."""
    with np.errstate(over="ignore"):
        z = _mix(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * _GAMMA)
        for word in (client_id, *extra):
            w = np.asarray(word).astype(np.uint64)
            z = _mix((z ^ w) * _GAMMA)
    return z


def uniform01(seed: int, client_id, *extra) -> np.ndarray:
    """U(0,1) draw from the (seed, client_id, *extra) stream (53-bit
    mantissa, the standard uint64 -> double construction)."""
    return (fold_in_host(seed, client_id, *extra) >> np.uint64(11)) * (
        1.0 / (1 << 53))


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One edge-device population: lognormal straggle (median
    `latency_median_s`, shape `latency_sigma`) + a no-show probability."""

    name: str
    weight: float            # population share (relative)
    latency_median_s: float  # median submission delay after an invite
    latency_sigma: float     # lognormal shape: the straggle tail
    no_show_prob: float      # invite ignored entirely


# the default population mix: mostly mid phones, a fast plugged-in slice,
# and a long-tailed slice of flaky low-end devices
DEFAULT_CLASSES = (
    DeviceClass("plugged", weight=0.2, latency_median_s=0.2,
                latency_sigma=0.3, no_show_prob=0.01),
    DeviceClass("phone", weight=0.6, latency_median_s=0.8,
                latency_sigma=0.6, no_show_prob=0.05),
    DeviceClass("flaky", weight=0.2, latency_median_s=2.0,
                latency_sigma=1.2, no_show_prob=0.25),
)


def device_class_index(seed: int, client_id,
                       classes=DEFAULT_CLASSES) -> np.ndarray:
    """Stable class assignment by population weight: a hash of (seed,
    client_id) against the cumulative weight table. Vectorized."""
    w = np.array([c.weight for c in classes], np.float64)
    edges = np.cumsum(w) / w.sum()
    u = uniform01(seed, client_id, 0xC1A55)
    return np.minimum(np.searchsorted(edges, u, side="right"),
                      len(classes) - 1)


def response_latency_s(seed: int, client_id, rnd: int,
                       classes=DEFAULT_CLASSES) -> np.ndarray:
    """Submission delay for (client, round): lognormal with the client's
    class parameters, drawn from the (seed, client_id, round) stream.
    np.inf = no-show (the invite is ignored). Vectorized over client_id;
    a 10M-ID population costs exactly the arrays passed in."""
    idx = device_class_index(seed, client_id, classes)
    med = np.array([c.latency_median_s for c in classes])[idx]
    sig = np.array([c.latency_sigma for c in classes])[idx]
    nsp = np.array([c.no_show_prob for c in classes])[idx]
    u_show = uniform01(seed, client_id, rnd, 0x5709)
    # inverse-CDF lognormal from a second independent fold
    u_lat = np.clip(uniform01(seed, client_id, rnd, 0x1A7), 1e-12, 1 - 1e-12)
    # rational approximation of the normal quantile (Acklam) — vectorized,
    # no scipy dependency; |error| < 1.2e-9 over the clipped range
    z = _norm_ppf(u_lat)
    lat = med * np.exp(sig * z)
    return np.where(u_show < nsp, np.inf, lat)


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    """Acklam's rational approximation of the standard normal quantile."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p = np.asarray(p, np.float64)
    lo, hi = 0.02425, 1 - 0.02425
    out = np.empty_like(p)
    # lower tail
    m = p < lo
    if m.any():
        q = np.sqrt(-2 * np.log(p[m]))
        out[m] = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                   * q + c[5])
                  / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    # central
    m = (p >= lo) & (p <= hi)
    if m.any():
        q = p[m] - 0.5
        r = q * q
        out[m] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
                   * r + a[5]) * q
                  / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
                     * r + 1))
    # upper tail
    m = p > hi
    if m.any():
        q = np.sqrt(-2 * np.log(1 - p[m]))
        out[m] = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                    * q + c[5])
                   / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    return out
