"""The Fig. 2 schemes of the port's slice (counterparts of
``repro.core.baselines``), as holders of their parameters.

The round arithmetic of each lives in the engine's scheme ports
(``fl/engine.py``), on tensors batched over trials:
  * IdealFedAvg      — noiseless mean (upper bound).
  * ProposedOTA      — biased OTA update with offline-designed params.
  * VanillaOTA [13]  — common pre-scaler set by the weakest instantaneous
                       channel (global CSI), zero instantaneous bias.
  * ProposedDigital  — biased digital update.
The remaining eleven Sec. V baselines arrive with ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from .digital import DigitalParams
from .ota import OTAParams


class Aggregator:
    """Base: one uplink scheme. Subclasses set ``name``."""

    name: str = "base"


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


class ProposedDigital(Aggregator):
    def __init__(self, params: DigitalParams,
                 label: str = "Proposed Digital FL (SCA)"):
        self.params = params
        self.name = label
