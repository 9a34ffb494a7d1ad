"""Seeded arrival processes: WHEN requests hit the fleet.

Open-loop load generation starts from an arrival-time schedule that does
not depend on the system under test (Schroeder et al., "Open Versus
Closed: A Cautionary Tale" — a closed loop's next arrival waits for the
previous completion, which hides queueing collapse exactly when you most
need to see it). Everything here is a pure function of its parameters
and ``seed``: one private ``random.Random`` stream per call, no module
state, no wall clock — the same determinism discipline as
``runtime/faults.py``, so two runs with the same seed produce the same
schedule byte for byte.

Time-varying rates (the bursty on/off and diurnal processes) use
Lewis–Shedler thinning over a homogeneous Poisson stream at the peak
rate: candidate gaps are exponential at ``rate_max`` and each candidate
survives with probability ``rate(t) / rate_max``. One RNG stream drives
both the gaps and the thinning coin so the schedule stays a pure
function of the seed.
"""

from __future__ import annotations

import math
import random
from typing import Callable, List


def _thinned(rate_fn: Callable[[float], float], rate_max: float,
             duration_s: float, seed) -> List[float]:
    """Arrival times in ``[0, duration_s)`` for the instantaneous rate
    function ``rate_fn`` (requests/sec), via thinning at ``rate_max``."""
    if rate_max < 0 or duration_s < 0:
        raise ValueError(
            f"rate and duration must be >= 0, got rate_max={rate_max}, "
            f"duration_s={duration_s}")
    out: List[float] = []
    if rate_max == 0 or duration_s == 0:
        return out
    rng = random.Random(f"loadgen-arrivals/{seed}")
    t = 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= duration_s:
            return out
        if rng.random() * rate_max <= rate_fn(t):
            out.append(t)


def poisson_arrivals(rate_rps: float, duration_s: float,
                     seed=0) -> List[float]:
    """Homogeneous Poisson process: independent exponential gaps at
    ``rate_rps`` — the steady open-loop baseline."""
    return _thinned(lambda _t: rate_rps, rate_rps, duration_s, seed)


def bursty_arrivals(base_rps: float, burst_rps: float,
                    burst_start_s: float, burst_s: float,
                    duration_s: float, seed=0) -> List[float]:
    """On/off process: ``base_rps`` background traffic with one burst
    window ``[burst_start_s, burst_start_s + burst_s)`` at ``burst_rps``
    — the scale-up trigger. The remainder of ``duration_s`` after the
    burst is the trough that lets a controller drain back down."""
    if burst_rps < base_rps:
        raise ValueError(
            f"burst_rps ({burst_rps}) must be >= base_rps ({base_rps})")

    def rate(t: float) -> float:
        if burst_start_s <= t < burst_start_s + burst_s:
            return burst_rps
        return base_rps

    return _thinned(rate, max(base_rps, burst_rps), duration_s, seed)


def diurnal_arrivals(trough_rps: float, peak_rps: float,
                     period_s: float, duration_s: float,
                     seed=0) -> List[float]:
    """Diurnal ramp: a raised-cosine rate that starts at ``trough_rps``,
    peaks at ``peak_rps`` mid-period, and returns to the trough — one
    compressed "day". The closing trough is where drain-based
    scale-down must land."""
    if peak_rps < trough_rps:
        raise ValueError(
            f"peak_rps ({peak_rps}) must be >= trough_rps ({trough_rps})")
    if period_s <= 0:
        raise ValueError(f"period_s must be > 0, got {period_s}")

    def rate(t: float) -> float:
        phase = 2.0 * math.pi * (t % period_s) / period_s
        return trough_rps + (peak_rps - trough_rps) \
            * 0.5 * (1.0 - math.cos(phase))

    return _thinned(rate, peak_rps, duration_s, seed)
