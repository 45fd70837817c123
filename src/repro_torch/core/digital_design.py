"""Digital-FL parameter design — the closed-form pieces of problem (17).

Counterpart of the solver-free part of ``repro.core.digital_design``:
the design spec, the latency model (12) with its threshold re-fit, the
paper's integer-bit finalization and the uniform anchor. Couplings:
    beta = p * nu,  rho = sqrt(-Lambda ln beta),
    R = log2(1 + E_s rho^2/N0),  nu = beta / p.
If a point violates the latency budget (17b), thresholds rise
(rho^2 *= kappa, bisected): beta falls and R rises, both of which shrink
latency, while p is unchanged since nu re-compensates.

The SCA / batched solvers arrive with ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .bounds import ObjectiveWeights
from .digital import DigitalParams


@dataclasses.dataclass(frozen=True)
class DigitalDesignSpec:
    lambdas: np.ndarray
    dim: int
    g_max: float
    e_s: float
    n0: float
    bandwidth_hz: float
    t_max_s: float
    weights: ObjectiveWeights
    r_max: int = 16

    @property
    def n(self) -> int:
        return int(self.lambdas.shape[0])

    @property
    def snr_gain(self) -> np.ndarray:
        """Lambda_m * E_s / N0 — SNR at |h|^2 = Lambda."""
        return np.asarray(self.lambdas) * self.e_s / self.n0


def _rate_from_beta(spec: DigitalDesignSpec, beta: np.ndarray) -> np.ndarray:
    """R = log2(1 + E_s rho^2/N0) with rho^2 = -Lambda ln beta."""
    snr = -spec.snr_gain * np.log(np.clip(beta, 1e-300, 1.0))
    return np.log2(1.0 + np.maximum(snr, 0.0))


def _latency(spec: DigitalDesignSpec, beta: np.ndarray,
             r_cont: np.ndarray) -> float:
    """Expected round latency (12) with continuous bits r'=r-1."""
    payload = 64.0 + spec.dim * (r_cont + 1.0)
    rate = np.maximum(_rate_from_beta(spec, beta), 1e-9)
    return float(np.sum(beta * payload / (spec.bandwidth_hz * rate)))


def _fit_latency(spec: DigitalDesignSpec, beta: np.ndarray,
                 r_cont: np.ndarray) -> np.ndarray:
    """Raise thresholds (scale rho^2) until the latency budget (17b) holds."""
    if _latency(spec, beta, r_cont) <= spec.t_max_s:
        return beta
    lo, hi = 1.0, 1.0
    while _latency(spec, beta ** hi, r_cont) > spec.t_max_s and hi < 1e6:
        hi *= 2.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if _latency(spec, beta ** mid, r_cont) > spec.t_max_s:
            lo = mid
        else:
            hi = mid
    return beta ** hi


def params_from(spec: DigitalDesignSpec, p: np.ndarray, beta: np.ndarray,
                r_bits: np.ndarray) -> DigitalParams:
    beta = np.clip(beta, 1e-12, 1.0 - 1e-12)
    rhos = np.sqrt(-np.asarray(spec.lambdas) * np.log(beta))
    nus = beta / p
    return DigitalParams(rhos=rhos, nus=nus,
                         r_bits=np.asarray(r_bits, dtype=np.int64),
                         g_max=spec.g_max, dim=spec.dim,
                         energy_per_symbol=spec.e_s, noise_psd=spec.n0,
                         bandwidth_hz=spec.bandwidth_hz)


def finalize(spec: DigitalDesignSpec, p: np.ndarray, beta: np.ndarray,
             r_cont: np.ndarray) -> DigitalParams:
    """Paper's integer rule r = floor(r')+1, then re-fit latency."""
    r_bits = np.clip(np.floor(r_cont).astype(np.int64) + 1, 1, spec.r_max)
    beta = _fit_latency(spec, np.clip(beta, 1e-12, 1 - 1e-12),
                        r_bits.astype(np.float64) - 1.0)
    return params_from(spec, p, beta, r_bits)


def anchor_uniform(spec: DigitalDesignSpec, beta0: float = 0.8
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """p = 1/N, common beta, max bits fitting 0.9*Tmax."""
    n = spec.n
    p = np.full(n, 1.0 / n)
    beta = np.full(n, beta0)
    r_cont = np.full(n, 0.5)
    for r in range(spec.r_max - 1, 0, -1):
        cand = np.full(n, float(r) - 0.5)
        if _latency(spec, beta, cand) <= 0.9 * spec.t_max_s:
            r_cont = cand
            break
    beta = _fit_latency(spec, beta, r_cont)
    return p, beta, r_cont
