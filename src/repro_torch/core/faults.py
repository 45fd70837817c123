"""Wireless fault model, host part (counterpart of ``repro.core.faults``).

Per round, each device independently drops out (``dropout_prob``), has
its payload erased (``erasure_prob``), hits a deep fade
(``|h| < deep_fade_thresh``) or straggles (``straggler_prob``, uplink
``straggler_mult`` times longer; with ``deadline_s`` its payload misses
the round). ``on_missing`` says what the PS does with a missing payload:
"reweight" (inverse propensity 1/q), "zero" or "stale".

This module holds the pure-data spec, the static statistics the design
layer reads (the survival probabilities q_m the "reweight" policy
inverts, the outage-adjusted channel energies the Sec.-IV solvers see)
and the per-round masks the engine's fault layer applies
(``fault_masks``, from one (3, N) block of the FAULT stream). The spec's
field order and defaults are the reference's, because they enter
``api.spec.spec_hash``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from .channel import participation_probability
from .digital import outage_mask

_POLICIES = ("reweight", "zero", "stale")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative wireless fault model (pure data, sweepable by axis).

    All probabilities are per device per round, i.i.d. across both.
    """

    dropout_prob: float = 0.0        # device silently absent this round
    erasure_prob: float = 0.0        # payload transmitted but undecodable
    deep_fade_thresh: float = 0.0    # |h| < thresh -> channel outage
    straggler_prob: float = 0.0      # device uplink slowed this round
    straggler_mult: float = 1.0      # straggler slowdown factor (>= 1)
    deadline_s: Optional[float] = None   # round deadline: stragglers miss
    on_missing: str = "reweight"     # "reweight" | "zero" | "stale"

    def __post_init__(self):
        for f in ("dropout_prob", "erasure_prob", "straggler_prob"):
            v = getattr(self, f)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"fault.{f} must be in [0, 1], got {v!r}")
        if self.deep_fade_thresh < 0.0:
            raise ValueError("fault.deep_fade_thresh must be >= 0, got "
                             f"{self.deep_fade_thresh!r}")
        if self.straggler_mult < 1.0:
            raise ValueError("fault.straggler_mult must be >= 1, got "
                             f"{self.straggler_mult!r}")
        if self.deadline_s is not None and self.deadline_s <= 0.0:
            raise ValueError("fault.deadline_s must be positive or None, "
                             f"got {self.deadline_s!r}")
        if self.on_missing not in _POLICIES:
            raise ValueError(f"fault.on_missing must be one of {_POLICIES}, "
                             f"got {self.on_missing!r}")

    @property
    def enabled(self) -> bool:
        """True iff any knob can change a trajectory (``straggler_mult``
        alone is inert: it scales stragglers that never occur)."""
        return (self.dropout_prob > 0.0 or self.erasure_prob > 0.0
                or self.deep_fade_thresh > 0.0 or self.straggler_prob > 0.0
                or self.deadline_s is not None)


def survival_prob(fault: FaultSpec, lambdas: np.ndarray) -> np.ndarray:
    """(N,) per-device round-survival probability q_m:
    ``(1 - dropout)(1 - erasure) exp(-t_f^2/Lambda_m)``, times
    ``(1 - straggler_prob)`` under a deadline; floored at 1e-12 so
    inverse-propensity weights stay finite."""
    q = (1.0 - fault.dropout_prob) * (1.0 - fault.erasure_prob)
    q = q * participation_probability(fault.deep_fade_thresh,
                                      np.asarray(lambdas, np.float64))
    if fault.deadline_s is not None:
        q = q * (1.0 - fault.straggler_prob)
    return np.maximum(q, 1e-12)


def effective_lambdas(lambdas: np.ndarray, fault: FaultSpec) -> np.ndarray:
    """Outage-adjusted average channel energies for fault-aware design:
    ``E[|h|^2 1{survives}] = q_u (Lambda + t_f^2) exp(-t_f^2/Lambda)``,
    floored at ``1e-12 * Lambda``; exactly ``lambdas`` when faults are
    disabled."""
    lam = np.asarray(lambdas, np.float64)
    if not fault.enabled:
        return lam
    tf2 = float(fault.deep_fade_thresh) ** 2
    q_u = (1.0 - fault.dropout_prob) * (1.0 - fault.erasure_prob)
    if fault.deadline_s is not None:
        q_u = q_u * (1.0 - fault.straggler_prob)
    return np.maximum(q_u * (lam + tf2) * np.exp(-tf2 / lam), 1e-12 * lam)


def fault_masks(u: torch.Tensor, habs: torch.Tensor, fault: FaultSpec):
    """Per-round delivery masks ``(ok, straggler)``, bool (..., N).

    ``u`` (..., 3, N) holds the round's FAULT uniforms widened to f64
    (rows: dropout, erasure, straggler), compared with the f64
    probabilities as the reference compares them; ``habs`` (..., N) the
    round's |h|, whose deep fades go through ``digital.outage_mask``.
    Leading dimensions (trials) broadcast. A straggler misses the round
    only under a deadline.
    """
    dropped = u[..., 0, :] < fault.dropout_prob
    erased = u[..., 1, :] < fault.erasure_prob
    straggler = u[..., 2, :] < fault.straggler_prob
    faded = ~outage_mask(habs, 0.0, deep_fade_thresh=fault.deep_fade_thresh)
    missed = dropped | erased | faded
    if fault.deadline_s is not None:
        missed = missed | straggler
    return ~missed, straggler
