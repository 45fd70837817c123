"""Wireless channel substrate: geometry, path loss, Rayleigh block fading.

NumPy copy of ``repro.core.channel`` (paper Sec. V network model): devices
uniform on a disk around the PS, log-distance path loss
PL(s) = PL0 + 10*Omega*log10(s/s0) [dB], Lambda_m = 10^{-PL/10}, and
Rayleigh block fading h_{m,t} ~ CN(0, Lambda_m), i.i.d. over rounds. The
streams are the reference's bit for bit (same generators, same seeds), so
a port run replays the reference's fading exactly.

``rng="fast"`` draws the fading from the counter-based threefry stream
instead (``sample_fading_fast``, the reference's ``sample_fading_jax``):
the same Rayleigh law, another stream, made on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import rngstream


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """Physical-layer constants (paper Sec. V defaults)."""

    n_devices: int = 50
    rho_max_m: float = 1750.0          # deployment disk radius [m]
    pl0_db: float = 50.0               # reference path loss at s0 [dB]
    pl_exponent: float = 2.2           # Omega
    s0_m: float = 1.0                  # reference distance [m]
    bandwidth_hz: float = 1.0e6        # B
    carrier_hz: float = 2.4e9          # f_c (informational)
    tx_power_dbm: float = 0.0          # P_tx -> E_s = P_tx / B  [J/symbol]
    noise_psd_dbm_hz: float = -173.0   # N0
    seed: int = 0

    @property
    def energy_per_symbol(self) -> float:
        """E_s [Joule/symbol]: average transmit energy per (complex) symbol."""
        p_tx_w = 10.0 ** (self.tx_power_dbm / 10.0) * 1e-3
        return p_tx_w / self.bandwidth_hz

    @property
    def noise_power(self) -> float:
        """N0 [W/Hz] spectral density in linear scale."""
        return 10.0 ** (self.noise_psd_dbm_hz / 10.0) * 1e-3


@dataclasses.dataclass(frozen=True)
class Deployment:
    """A fixed device deployment: distances and average channel gains."""

    distances_m: np.ndarray     # (N,)
    lambdas: np.ndarray         # (N,) average channel gains Lambda_m
    cfg: WirelessConfig

    @property
    def n_devices(self) -> int:
        return int(self.lambdas.shape[0])


def path_loss_db(distance_m: np.ndarray, cfg: WirelessConfig) -> np.ndarray:
    d = np.maximum(np.asarray(distance_m, dtype=np.float64), cfg.s0_m)
    return cfg.pl0_db + 10.0 * cfg.pl_exponent * np.log10(d / cfg.s0_m)


def make_deployment(cfg: WirelessConfig,
                    seed: Optional[int] = None) -> Deployment:
    """Sample a device deployment (fixed for the whole FL run, Sec. V)."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    u = rng.uniform(size=cfg.n_devices)
    s = cfg.rho_max_m * np.sqrt(u)
    # the polar angle is drawn so the stream stays the reference's, though
    # only the radius enters the path loss
    rng.uniform(0.0, 2.0 * np.pi, size=cfg.n_devices)
    lambdas = 10.0 ** (-path_loss_db(s, cfg) / 10.0)
    return Deployment(distances_m=s, lambdas=lambdas, cfg=cfg)


def sample_fading(lambdas: np.ndarray, seed: int, t: int) -> np.ndarray:
    """Complex h_{m,t} ~ CN(0, Lambda_m) for one round, deterministic in
    (seed, t)."""
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=(int(seed), int(t))))
    n = lambdas.shape[0]
    scale = np.sqrt(lambdas / 2.0)
    re = rng.normal(size=n) * scale
    im = rng.normal(size=n) * scale
    return re + 1j * im


def _fading_fast(key, lambdas, device) -> torch.Tensor:
    """h = (z0 + i z1) sqrt(Lambda / 2) from the f64 normals z (2, N) of
    ``key`` (a key pair, ints or (..., 1) tensors): complex128 (..., N)."""
    z = rngstream.normal_f64(key, (2, len(lambdas)), device=device)
    scale = torch.sqrt(torch.as_tensor(np.asarray(lambdas, np.float64),
                                       device=device) / 2.0)
    return torch.complex(z[..., 0, :] * scale, z[..., 1, :] * scale)


def sample_fading_fast(key, t: int, lambdas, *,
                       device="cpu") -> torch.Tensor:
    """Counter-based h_{m,t} ~ CN(0, Lambda_m) (the reference's
    ``sample_fading_jax``) from ``fold_in(key, t)``; ``key`` is
    ``stream_base_key(seed, trial, FADING_TAG)``. Complex128 (N,)."""
    return _fading_fast(rngstream.fold_in(key, t), lambdas, device)


def fading_abs_fast(keys, rounds: int, lambdas, *, t0: int = 0,
                    device="cpu") -> torch.Tensor:
    """(K, rounds, N) f64 |h| of :func:`sample_fading_fast` for K trial
    keys and rounds t0 .. t0 + rounds - 1, in one pass on ``device``."""
    return torch.abs(_fading_fast(
        rngstream.round_keys(keys, rounds, t0=t0, device=device), lambdas,
        device))


def sample_fading_batch(lambdas: np.ndarray, seed: int,
                        rounds: int) -> np.ndarray:
    """(T, N) fading tensor: rows t = 0..rounds-1 of ``sample_fading``."""
    if rounds == 0:
        return np.zeros((0, lambdas.shape[0]), dtype=np.complex128)
    return np.stack([sample_fading(lambdas, seed, t) for t in range(rounds)])


class FadingProcess:
    """Rayleigh block-fading generator, i.i.d. across rounds."""

    def __init__(self, deployment: Deployment, seed: int = 0):
        self._lambdas = deployment.lambdas
        self._seed = seed

    def sample(self, t: int) -> np.ndarray:
        return sample_fading(self._lambdas, self._seed, t)

    def gains(self, t: int) -> np.ndarray:
        """|h_{m,t}| magnitudes for round t."""
        return np.abs(self.sample(t))


def participation_probability(threshold: np.ndarray,
                              lambdas: np.ndarray) -> np.ndarray:
    """P(|h_m| >= threshold_m) = exp(-threshold^2/Lambda) under Rayleigh
    fading; the fault layer's deep-fade survival term
    (``core.faults.survival_prob``)."""
    thr = np.asarray(threshold, dtype=np.float64)
    return np.exp(-(thr ** 2) / np.asarray(lambdas, dtype=np.float64))
