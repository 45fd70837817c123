"""Core library of the port: the paper's biased wireless-FL contribution.

  channel     — deployment geometry, path loss, Rayleigh fading (NumPy)
  rngstream   — threefry dither stream, bit-equal to the reference
  ota         — biased OTA aggregation (Sec. II-A)
  digital     — biased digital aggregation (Sec. II-B)
  quantize    — digital payload size
  bounds      — design-objective weights
  ota_design / digital_design — closed-form Sec. IV design anchors
  baselines   — the Fig. 2 schemes of this slice
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
