"""Buffered-asynchronous FL, host part (counterpart of
``repro.core.async_fl``).

Under ``run.mode="async"`` device m delivers a round's update with
static probability r_m (:func:`arrival_rates`), computed S rounds ago
with S geometric(r_m) inside a K-round buffer, and weighted by
``delta^S``. This module holds the pure-data spec and the float64 tables
the design layer prices the stationary staleness with: rates, the
staleness CDF and pmf, the delivery weights c_m and the expected
staleness. Field order and defaults are the reference's, because they
enter ``api.spec.spec_hash``. The round itself (``resolve``,
``async_round``, ``stale_replace``) arrives with ROADMAP Queue 1 item 9;
until then ``mode="async"`` raises in ``fl.engine.check_slice``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MODES = ("sync", "async")
ON_MISSING = ("zero", "stale")
WEIGHTINGS = ("uniform", "designed")

#: Floor on per-device arrival rates (a rate of 0 would make the staleness
#: geometry degenerate and the device silent forever).
RATE_MIN = 1e-3


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """Buffered-async knobs (``async_.*`` sweep axes; inert under
    ``run.mode="sync"``).

    buffer_rounds       K — staleness buffer depth (S in {0, ..., K-1}).
    arrival_rate        mean per-round completion probability r.
    rate_heterogeneity  log-spread h: rates span ``r * (1+h)^{±1}``.
    staleness_discount  delta — weight ``delta^S`` on a staleness-S payload.
    on_missing          "zero" | "stale".
    weighting           "uniform" (v = 1) | "designed" (solved weights).
    """

    buffer_rounds: int = 4
    arrival_rate: float = 0.7
    rate_heterogeneity: float = 0.0
    staleness_discount: float = 1.0
    on_missing: str = "zero"
    weighting: str = "uniform"

    def __post_init__(self):
        if int(self.buffer_rounds) < 1:
            raise ValueError(
                f"buffer_rounds must be >= 1, got {self.buffer_rounds!r}")
        if not 0.0 < float(self.arrival_rate) <= 1.0:
            raise ValueError(
                f"arrival_rate must be in (0, 1], got {self.arrival_rate!r}")
        if float(self.rate_heterogeneity) < 0.0:
            raise ValueError(
                "rate_heterogeneity must be >= 0, got "
                f"{self.rate_heterogeneity!r}")
        if not 0.0 < float(self.staleness_discount) <= 1.0:
            raise ValueError(
                "staleness_discount must be in (0, 1], got "
                f"{self.staleness_discount!r}")
        if self.on_missing not in ON_MISSING:
            raise ValueError(
                f"async on_missing must be one of {ON_MISSING}, got "
                f"{self.on_missing!r}")
        if self.weighting not in WEIGHTINGS:
            raise ValueError(
                f"async weighting must be one of {WEIGHTINGS}, got "
                f"{self.weighting!r}")


def arrival_rates(spec: AsyncSpec, n_devices: int) -> np.ndarray:
    """(N,) per-round completion probabilities
    ``r_m = clip(arrival_rate * (1+h)^{x_m}, RATE_MIN, 1)``, x_m linearly
    spaced on [-1, 1] (device 0 the slowest)."""
    n = int(n_devices)
    x = np.linspace(-1.0, 1.0, n) if n > 1 else np.zeros(1)
    g = 1.0 + float(spec.rate_heterogeneity)
    return np.clip(float(spec.arrival_rate) * g ** x, RATE_MIN, 1.0)


def staleness_cdf(rates: np.ndarray, buffer_rounds: int) -> np.ndarray:
    """(K, N) staleness CDF thresholds: row j is
    ``P(S <= j) = 1 - (1-r)^{j+1}``."""
    r = np.asarray(rates, dtype=np.float64)
    j = np.arange(1, int(buffer_rounds) + 1, dtype=np.float64)[:, None]
    return 1.0 - (1.0 - r)[None, :] ** j


def staleness_pmf(rates: np.ndarray, buffer_rounds: int) -> np.ndarray:
    """(K, N) in-window staleness pmf: row s is P(S = s)."""
    cdf = staleness_cdf(rates, buffer_rounds)
    n = cdf.shape[1]
    return np.diff(np.concatenate([np.zeros((1, n)), cdf], axis=0), axis=0)


def delivery_weight(spec: AsyncSpec, n_devices: int) -> np.ndarray:
    """(N,) c_m = E[delta^S ; delivered within the window] per round."""
    r = arrival_rates(spec, n_devices)
    pmf = staleness_pmf(r, spec.buffer_rounds)
    disc = float(spec.staleness_discount) ** np.arange(int(spec.buffer_rounds))
    return r * np.sum(disc[:, None] * pmf, axis=0)


def expected_staleness(spec: AsyncSpec, n_devices: int) -> np.ndarray:
    """(N,) E[S | delivered within the window], the co-design solver's
    per-device staleness penalty weight."""
    r = arrival_rates(spec, n_devices)
    pmf = staleness_pmf(r, spec.buffer_rounds)
    s = np.arange(int(spec.buffer_rounds), dtype=np.float64)
    mass = np.maximum(pmf.sum(axis=0), 1e-300)
    return np.sum(s[:, None] * pmf, axis=0) / mass
