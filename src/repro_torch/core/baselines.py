"""The paper's Sec. V schemes (counterparts of ``repro.core.baselines``),
as holders of their parameters.

Constructors are the reference's, in host NumPy, so a scheme builds from a
deployment without the reference. The round arithmetic of each lives in
the engine's scheme ports (``fl/engine.py``), on tensors batched over
trials.

OTA schemes (Sec. V-A-1):
  * IdealFedAvg        — noiseless mean (upper bound).
  * ProposedOTA        — biased OTA update with offline-designed params.
  * VanillaOTA   [13]  — common pre-scaler set by the weakest instantaneous
                         channel (global CSI), zero instantaneous bias.
  * OPCOTAComp   [19]  — per-round MSE-optimal power control (global CSI).
  * LCPCOTAComp  [19]  — common tunable pre-scaler, statistical CSI.
  * OPCOTAFL     [20]  — genie-aided per-round threshold power control.
  * BBFLInterior [16]  — schedule devices within rho_in, trunc. inversion.
  * BBFLAlternative[16]— alternate all-device / interior rounds.

Digital schemes (Sec. V-A-2), each charged channel-capacity latency:
  * ProposedDigital    — biased digital update.
  * BestChannel  [7]   — top-K instantaneous |h|, equal bits.
  * BestChannelNorm[7] — top-K' by |h| then top-K by ||g||, bits ∝ norms.
  * PropFairness [9]   — top-K by |h|^2/Lambda.
  * UQOS         [32]  — optimized unbiased sampling, common fixed rate.
  * QML          [11]  — min-latency bit allocation under variance cap.
  * FedTOE       [10]  — equal-outage rates, variance-min bit allocation.
"""
from __future__ import annotations

import numpy as np

from .channel import Deployment
from .digital import DigitalParams
from .ota import OTAParams, uniform_gamma_min_variance


class Aggregator:
    """Base: one uplink scheme. Subclasses set ``name``."""

    name: str = "base"


# --------------------------------------------------------------------- OTA

class IdealFedAvg(Aggregator):
    name = "Ideal FedAvg"


class ProposedOTA(Aggregator):
    """Our scheme: offline-designed (gamma, alpha) biased OTA update."""

    def __init__(self, params: OTAParams,
                 label: str = "Proposed OTA-FL (SCA)"):
        self.params = params
        self.name = label


class VanillaOTA(Aggregator):
    """[13]: all devices invert with a common pre-scaler set by the weakest
    instantaneous channel, gamma_t = sqrt(d E_s) min_m |h_m| / G_max."""

    name = "Vanilla OTA-FL"

    def __init__(self, dim: int, g_max: float, e_s: float, n0: float):
        self.dim, self.g_max, self.e_s, self.n0 = dim, g_max, e_s, n0


class OPCOTAComp(Aggregator):
    """[19] per-round MSE-optimal (eta, {b_m}) with global instantaneous
    CSI, eta searched on an ``n_grid``-point log grid."""

    name = "OPC OTA-Comp"

    def __init__(self, dim: int, g_max: float, e_s: float, n0: float,
                 n_grid: int = 64):
        self.dim, self.g_max, self.e_s, self.n0 = dim, g_max, e_s, n0
        self.n_grid = n_grid


class LCPCOTAComp(Aggregator):
    """[19] low-complexity power control: one common truncated-inversion
    pre-scaler optimized offline from channel statistics."""

    name = "LCPC OTA-Comp"

    def __init__(self, deployment: Deployment, dim: int, g_max: float,
                 e_s: float, n0: float):
        gamma = uniform_gamma_min_variance(deployment.lambdas, dim, e_s,
                                           g_max, n0)
        gammas = np.full(deployment.n_devices, gamma)
        a_m = gammas * np.exp(-(gammas ** 2) * g_max ** 2
                              / (dim * deployment.lambdas * e_s))
        self.params = OTAParams(gammas=gammas, alpha=float(np.sum(a_m)),
                                g_max=g_max, dim=dim, energy_per_symbol=e_s,
                                noise_psd=n0)


class OPCOTAFL(Aggregator):
    """[20] genie-aided per-round common inversion threshold chosen with
    full current-round CSI, no PS post-scaler constraint."""

    name = "OPC OTA-FL (genie)"

    def __init__(self, dim: int, g_max: float, e_s: float, n0: float):
        self.dim, self.g_max, self.e_s, self.n0 = dim, g_max, e_s, n0


class BBFLInterior(Aggregator):
    """[16] cell-interior scheduling: devices within rho_in_frac of the
    disk radius, truncated inversion with a statistically-tuned common
    pre-scaler; the PS divides by |S_t| gamma."""

    name = "BB-FL Interior"

    def __init__(self, deployment: Deployment, dim: int, g_max: float,
                 e_s: float, n0: float, rho_in_frac: float = 0.7):
        self.interior = (deployment.distances_m
                         <= rho_in_frac * deployment.cfg.rho_max_m)
        lam_in = deployment.lambdas[self.interior]
        self.gamma = uniform_gamma_min_variance(lam_in, dim, e_s, g_max, n0)
        self.dim, self.g_max, self.e_s, self.n0 = dim, g_max, e_s, n0


class BBFLAlternative(Aggregator):
    """[16] alternating scheduling: even rounds all devices, odd rounds the
    interior policy."""

    name = "BB-FL Alternative"

    def __init__(self, deployment: Deployment, dim: int, g_max: float,
                 e_s: float, n0: float, rho_in_frac: float = 0.7):
        self.interior_agg = BBFLInterior(deployment, dim, g_max, e_s, n0,
                                         rho_in_frac)
        self.all_mask = np.ones(deployment.n_devices, dtype=bool)
        self.gamma_all = uniform_gamma_min_variance(
            deployment.lambdas, dim, e_s, g_max, n0)
        self.dim, self.g_max, self.e_s, self.n0 = dim, g_max, e_s, n0


# ----------------------------------------------------------------- digital

class ProposedDigital(Aggregator):
    def __init__(self, params: DigitalParams,
                 label: str = "Proposed Digital FL (SCA)"):
        self.params = params
        self.name = label


class _DigitalBase(Aggregator):
    def __init__(self, deployment: Deployment, dim: int, g_max: float,
                 e_s: float, n0: float, bandwidth_hz: float):
        self.dep = deployment
        self.dim, self.g_max = dim, g_max
        self.e_s, self.n0, self.B = e_s, n0, bandwidth_hz


class BestChannel(_DigitalBase):
    """[7]: top-K devices by instantaneous channel gain, equal bits."""

    def __init__(self, deployment, dim, g_max, e_s, n0, bandwidth_hz,
                 k: int = 4, r_bits: int = 6):
        super().__init__(deployment, dim, g_max, e_s, n0, bandwidth_hz)
        self.k, self.r = k, r_bits
        self.name = "Best Channel"


class BestChannelNorm(_DigitalBase):
    """[7]: top-K' by channel then top-K by gradient norm, bits ∝ norms."""

    def __init__(self, deployment, dim, g_max, e_s, n0, bandwidth_hz,
                 k: int = 4, k_prime: int = 6, r_total: int = 24):
        super().__init__(deployment, dim, g_max, e_s, n0, bandwidth_hz)
        self.k, self.kp, self.r_total = k, k_prime, r_total
        self.name = "Best Channel-Norm"


class PropFairness(_DigitalBase):
    """[9]: top-K by normalized fading |h|^2/Lambda."""

    def __init__(self, deployment, dim, g_max, e_s, n0, bandwidth_hz,
                 k: int = 4, r_bits: int = 6):
        super().__init__(deployment, dim, g_max, e_s, n0, bandwidth_hz)
        self.k, self.r = k, r_bits
        self.name = "Proportional Fairness"


class UQOS(_DigitalBase):
    """[32]: K devices sampled without replacement with inclusion
    probabilities pi ∝ 1/sqrt(p_succ) (capped at 1), common fixed rate."""

    def __init__(self, deployment, dim, g_max, e_s, n0, bandwidth_hz,
                 k: int = 4, r_bits: int = 6, rate: float = 0.5):
        super().__init__(deployment, dim, g_max, e_s, n0, bandwidth_hz)
        self.k, self.r, self.rate = k, r_bits, rate
        thr2 = (2.0 ** rate - 1.0) * n0 / e_s
        self.p_succ = np.exp(-thr2 / deployment.lambdas)
        pi = 1.0 / np.sqrt(np.maximum(self.p_succ, 1e-9))
        # waterfill pi ∝ 1/sqrt(p_succ) with sum = K, pi <= 1
        pi = pi * self.k / np.sum(pi)
        for _ in range(50):
            over = pi > 1.0
            if not np.any(over):
                break
            deficit = self.k - np.sum(over)
            pi[over] = 1.0
            free = ~over
            pi[free] = pi[free] * deficit / np.sum(pi[free])
        self.pi = np.clip(pi, 1e-6, 1.0)
        self.name = "UQOS"


class QML(_DigitalBase):
    """[11]: K random devices; the smallest common bit-width meeting the
    per-device quantization-variance cap d G^2 / (2^r - 1)^2 <= var_cap
    (static, as the reference's engine computes it)."""

    def __init__(self, deployment, dim, g_max, e_s, n0, bandwidth_hz,
                 k: int = 4, var_cap: float = 200.0, r_max: int = 16):
        super().__init__(deployment, dim, g_max, e_s, n0, bandwidth_hz)
        self.k, self.var_cap, self.r_max = k, var_cap, r_max
        r = 1
        while (dim * g_max ** 2 / (2.0 ** r - 1.0) ** 2 > var_cap
               and r < r_max):
            r += 1
        self.r = r
        self.name = "QML"


class FedTOE(_DigitalBase):
    """[10]: equal outage probability across devices; K random devices;
    greedy bit allocation minimizing quantization variance under the round
    latency budget; unbiased success reweighting."""

    def __init__(self, deployment, dim, g_max, e_s, n0, bandwidth_hz,
                 k: int = 4, p_out: float = 0.1, t_budget_s: float = 0.22,
                 r_max: int = 16):
        super().__init__(deployment, dim, g_max, e_s, n0, bandwidth_hz)
        self.k, self.p_out, self.t_budget, self.r_max = (k, p_out,
                                                         t_budget_s, r_max)
        # fixed per-device rates with common outage prob
        thr2 = -deployment.lambdas * np.log1p(-p_out)
        self.rates = np.log2(1.0 + e_s * thr2 / n0)
        self.thr = np.sqrt(thr2)
        self.name = "FedTOE"
