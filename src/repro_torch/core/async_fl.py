"""Buffered-asynchronous FL (counterpart of ``repro.core.async_fl``).

Under ``run.mode="async"`` device m delivers a round's update with
static probability r_m (:func:`arrival_rates`), computed S rounds ago
with S geometric(r_m) inside a K-round buffer, and weighted by
``delta^S``. This module holds the pure-data spec, the float64 tables
the design layer prices the stationary staleness with (rates, the
staleness CDF and pmf, the delivery weights c_m and the expected
staleness), the resolved configuration the engine runs, and the round
itself on torch tensors with trials leading: :func:`async_round` (the
buffer shift, the delivery and staleness draws as exact comparisons of
the f64-widened ARRIVAL uniforms against the tables, the gather and the
``delta^S v N / sum(c v)`` scale) and :func:`stale_replace`, the one
last-gradient path behind both "stale" policies. Field order and
defaults are the reference's, because they enter ``api.spec.spec_hash``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

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


@dataclasses.dataclass(frozen=True)
class ResolvedAsync:
    """Validated async configuration (hashable: the tables are float64
    tuples, compared by content)."""

    buffer_rounds: int           # K — buffer depth / max staleness + 1
    on_missing: str              # "zero" | "stale"
    staleness_discount: float    # delta
    weighting: str               # provenance: "uniform" | "designed"
    rates: tuple                 # (N,) per-round completion probabilities
    weights: tuple               # (N,) PS per-device weights v, sum == N

    @property
    def n_devices(self) -> int:
        return len(self.rates)

    def rates_array(self) -> np.ndarray:
        return np.asarray(self.rates, dtype=np.float64)

    def weights_array(self) -> np.ndarray:
        return np.asarray(self.weights, dtype=np.float64)

    def cdf_array(self) -> np.ndarray:
        """(K, N) staleness CDF thresholds (:func:`staleness_cdf`)."""
        return staleness_cdf(self.rates_array(), self.buffer_rounds)

    def discounts_array(self) -> np.ndarray:
        """(K,) staleness discount table delta^s."""
        return (float(self.staleness_discount)
                ** np.arange(int(self.buffer_rounds), dtype=np.float64))

    def delivery_weight_array(self) -> np.ndarray:
        """(N,) c_m (:func:`delivery_weight`)."""
        r = self.rates_array()
        pmf = staleness_pmf(r, self.buffer_rounds)
        return r * np.sum(self.discounts_array()[:, None] * pmf, axis=0)

    def payload_scale_array(self) -> np.ndarray:
        """(N,) per-device payload scale ``v_m * N / sum(c v)``, which
        keeps the expected delivered mass at N."""
        c = self.delivery_weight_array()
        v = self.weights_array()
        return v * (self.n_devices / float(np.sum(c * v)))


def resolve(mode: str, spec: Optional[AsyncSpec], n_devices: int,
            weights=None) -> Optional[ResolvedAsync]:
    """Normalize the (mode, spec, weights) knobs: None under
    ``mode="sync"``, else a validated :class:`ResolvedAsync`. Explicit
    ``weights`` (the designed ones) override the weighting policy and
    must lie on {sum v = N, v > 0}."""
    if mode not in MODES:
        raise ValueError(f"run mode must be one of {MODES}, got {mode!r}")
    if mode == "sync":
        if weights is not None:
            raise ValueError(
                "async_weights given but run mode is 'sync'; set "
                "mode='async' to enable buffered-async aggregation")
        return None
    spec = spec if spec is not None else AsyncSpec()
    n = int(n_devices)
    if weights is not None:
        v = np.asarray(weights, dtype=np.float64)
        if v.shape != (n,):
            raise ValueError(
                f"async_weights must have shape ({n},), got {v.shape}")
        if np.any(v <= 0.0) or not np.all(np.isfinite(v)):
            raise ValueError("async_weights must be finite and > 0")
        if abs(float(v.sum()) - n) > 1e-6 * n:
            raise ValueError(
                f"async_weights must sum to n_devices={n}, got sum "
                f"{float(v.sum()):.9g}")
    elif spec.weighting == "uniform":
        v = np.ones(n)
    else:   # "designed" without explicit weights
        raise ValueError(
            "async weighting='designed' needs explicit async_weights "
            "(solve them with core.sca_jax.solve_async_batch, e.g. via "
            "api.materialize.CellContext.async_weights)")
    return ResolvedAsync(buffer_rounds=int(spec.buffer_rounds),
                         on_missing=spec.on_missing,
                         staleness_discount=float(spec.staleness_discount),
                         weighting=spec.weighting,
                         rates=tuple(arrival_rates(spec, n).tolist()),
                         weights=tuple(v.tolist()))


def async_round(g, buf, u, rates, cdf, discounts, pay_scale):
    """One buffered-async delivery step on torch tensors.

    ``g`` (..., N, d) the round's fresh gradients (already cast and
    participation-scaled), ``buf`` (..., K, N, d) the buffer (slot s =
    gradients computed s rounds ago, before this round's shift), ``u``
    (..., 2, N) the round's ARRIVAL uniforms widened to f64, ``rates``
    (N,), ``cdf`` (K, N), ``discounts`` (K,) and ``pay_scale`` (N,) the
    resolved f64 tables on g's device; leading dimensions are trials.

    Returns ``(payload, ok, buf_new)``: ``delta^S v N/sum(cv) g(w_{t-S})``
    per device, the bool delivery mask (no completion, or S >= K), and
    the shifted buffer. The staleness S is the count of CDF rows the
    uniform reaches, so only exact comparisons touch the draws.
    """
    buf = torch.cat([g.unsqueeze(-3), buf[..., :-1, :, :]], dim=-3)
    k = buf.shape[-3]
    deliver = u[..., 0, :] < rates
    crossed = (u[..., 1, :].unsqueeze(-2) >= cdf).sum(-2)   # (..., N)
    ok = deliver & (crossed < k)
    s = torch.clamp(crossed, max=k - 1)
    index = s.unsqueeze(-2).unsqueeze(-1).expand(
        s.shape[:-1] + (1,) + g.shape[-2:])
    g_sel = torch.gather(buf, -3, index).squeeze(-3)
    payload = g_sel * (discounts[s] * pay_scale).unsqueeze(-1)
    return payload, ok, buf


def stale_replace(g, ok, g_last):
    """Missing payloads replay the last received ones; returns
    ``(g_new, g_last_new)``, the carry being the payloads the PS
    consumed. The one path behind ``fault.on_missing="stale"`` and the
    async layer's ``on_missing="stale"``."""
    g_new = torch.where(ok.unsqueeze(-1), g, g_last)
    return g_new, g_new
