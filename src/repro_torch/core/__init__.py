"""Core library of the port: the paper's biased wireless-FL contribution.

  channel     — deployment geometry, path loss, Rayleigh fading (NumPy)
  rngstream   — threefry dither and layer streams, bit-equal to the
                reference
  ota         — biased OTA aggregation (Sec. II-A)
  digital     — biased digital aggregation (Sec. II-B)
  quantize    — digital payload size
  bounds      — Theorem 1/2 bounds and the design-objective weights
  sca         — the SciPy SCA loop (host code, the trusted oracle)
  sca_torch   — the batched Sec. IV solver in float64 torch
  ota_design / digital_design — Sec. IV design: anchors, the SCA and
                direct solvers, the batched wrappers
  baselines   — the Sec. V schemes
  collectives — wireless_psum, the FL-LM train step's aggregation
  faults / participation / async_fl — the engine's fault, client-sampling
                and buffered-async layers: specs, static tables and
                their per-round masks on torch tensors
"""
from .channel import (WirelessConfig, Deployment, FadingProcess,
                      make_deployment)
from .ota import OTAParams, ota_round
from .digital import DigitalParams, digital_round
from .bounds import ObjectiveWeights, bias_sum
from .ota_design import OTADesignSpec
from .digital_design import DigitalDesignSpec

__all__ = [
    "WirelessConfig", "Deployment", "FadingProcess", "make_deployment",
    "OTAParams", "ota_round", "DigitalParams", "digital_round",
    "ObjectiveWeights", "bias_sum", "OTADesignSpec", "DigitalDesignSpec",
]
