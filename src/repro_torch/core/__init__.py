"""Core library of the port: the paper's biased wireless-FL contribution.

  channel     — deployment geometry, path loss, Rayleigh fading (NumPy)
  rngstream   — threefry dither stream, bit-equal to the reference
  ota         — biased OTA aggregation (Sec. II-A)
  digital     — biased digital aggregation (Sec. II-B)
  quantize    — digital payload size
  bounds      — design-objective weights
  ota_design / digital_design — Sec. IV design anchors and the direct
                OTA solver
  baselines   — the Sec. V schemes
  collectives — wireless_psum, the FL-LM train step's aggregation
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
