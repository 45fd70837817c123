"""Partial device participation: per-round client sampling as priced bias
(counterpart of ``repro.core.participation``).

The PS samples a cohort of expected size S = ``clients_per_round`` each
round by independent Bernoulli draws with static inclusion probabilities
pi_m, sum_m pi_m = S: device m takes part iff ``u_m < pi_m`` for the
round's (N,) PARTICIPATE uniforms (``core.rngstream``), widened to f64.
A participating device's gradient is scaled by the uniform inverse
propensity N/S (not 1/pi_m), so a non-uniform pi tilts device m's effective
participation to ``p_m * pi_m * N/S``, the static sampling bias the
Sec.-IV bound prices.

Policies (``POLICIES``): "uniform" (pi = S/N), "channel" (pi
proportional to Lambda_m on the capped simplex), "designed" (explicit
probabilities from the co-design solver), "datasize" and "loss" (pi
proportional to |D_m| or to each device's loss at the initial model).
Explicit ``participation_probs`` override any policy.
``clients_per_round=None`` disables the layer (:func:`resolve` returns
None and the engine runs its program without it).

Everything here is host NumPy, as in the reference, and its error
messages are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

POLICIES = ("uniform", "channel", "designed", "loss", "datasize")

#: Policies whose pi needs per-device weights the trainer/engine derive
#: from their task/dataset (:func:`policy_weights`).
WEIGHTED_POLICIES = ("loss", "datasize")


@dataclasses.dataclass(frozen=True)
class ResolvedParticipation:
    """Validated sampling configuration (hashable; ``probs`` a float64
    tuple, so two trainers' configurations compare by content)."""

    clients: int                 # S — expected cohort size per round
    policy: str                  # provenance: "uniform"|"channel"|"designed"
    probs: tuple                 # (N,) inclusion probabilities, sum == S

    @property
    def n_devices(self) -> int:
        return len(self.probs)

    @property
    def scale(self) -> float:
        """The uniform inverse-propensity payload scale N/S."""
        return self.n_devices / self.clients

    def probs_array(self) -> np.ndarray:
        return np.asarray(self.probs, dtype=np.float64)


def capped_proportional(weights: np.ndarray, clients: int,
                        tol: float = 1e-12) -> np.ndarray:
    """Scale ``weights`` onto the capped simplex {sum pi = S, pi <= 1}:
    water-filling bisection on c in ``pi = min(c * w, 1)``, the root
    bracketed by doubling, then the bisection's O(tol) gap on sum(pi)
    closed on the uncapped coordinates."""
    w = np.asarray(weights, dtype=np.float64)
    n = w.shape[0]
    if np.any(w < 0) or not np.all(np.isfinite(w)):
        raise ValueError("participation weights must be finite and >= 0")
    s = float(clients)
    if s >= n:
        return np.ones(n)
    pos = w > 0
    if int(pos.sum()) < clients:
        raise ValueError(
            f"clients_per_round={clients} exceeds the {int(pos.sum())} "
            "devices with positive participation weight")
    total = lambda c: float(np.sum(np.minimum(c * w, 1.0)))
    hi = 1.0 / float(np.max(w))
    while total(hi) < s:
        hi *= 2.0
    lo = 0.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if total(mid) < s:
            lo = mid
        else:
            hi = mid
        if hi - lo <= tol * max(hi, 1.0):
            break
    pi = np.minimum(hi * w, 1.0)
    free = pi < 1.0
    gap = s - float(pi.sum())
    if np.any(free):
        pi[free] += gap * (pi[free] / max(float(pi[free].sum()), 1e-300))
    return np.clip(pi, 0.0, 1.0)


def datasize_weights(dataset) -> np.ndarray:
    """(N,) float64 device dataset sizes |D_m| (the "datasize" policy)."""
    return np.asarray([float(len(d)) for d in dataset.devices], np.float64)


def loss_weights(task, dataset, device="cpu") -> np.ndarray:
    """(N,) float64 per-device local loss at the initial model (the
    "loss" policy), each the task's f32 loss of the f32-cast w0 on the
    device's data, computed on ``device``."""
    w0 = task.init_params(device=device).to(torch.float32)
    out = []
    for d in dataset.devices:
        x = torch.as_tensor(np.asarray(d.x, np.float32), device=device)
        y = torch.as_tensor(np.asarray(d.y, np.int64), device=device)
        out.append(float(task.loss(w0, x, y)))
    return np.asarray(out, np.float64)


def policy_weights(policy: str, task=None, dataset=None, device="cpu"):
    """The per-device weights a :data:`WEIGHTED_POLICIES` policy scales
    onto the capped simplex, or None for the policies that need none."""
    if policy not in WEIGHTED_POLICIES:
        return None
    if task is None or dataset is None:
        raise ValueError(
            f"participation={policy!r} needs the task and dataset to "
            "derive its sampling weights")
    if policy == "datasize":
        return datasize_weights(dataset)
    return loss_weights(task, dataset, device=device)


def resolve(clients_per_round: Optional[int], policy: str = "uniform",
            probs=None, *, n_devices: int, lambdas=None,
            weights=None) -> Optional[ResolvedParticipation]:
    """Normalize the (clients, policy, probs) knobs: None when
    ``clients_per_round`` is None, else a validated
    :class:`ResolvedParticipation`. Explicit ``probs`` override the
    policy; "channel" needs ``lambdas``, "loss"/"datasize" ``weights``."""
    if clients_per_round is None:
        if probs is not None:
            raise ValueError(
                "participation_probs given but clients_per_round is None; "
                "set clients_per_round to enable partial participation")
        return None
    if policy not in POLICIES:
        raise ValueError(
            f"participation must be one of {POLICIES}, got {policy!r}")
    s = int(clients_per_round)
    if not 1 <= s <= n_devices:
        raise ValueError(
            f"clients_per_round must be in [1, n_devices={n_devices}], "
            f"got {clients_per_round!r}")
    if probs is not None:
        pi = np.asarray(probs, dtype=np.float64)
        if pi.shape != (n_devices,):
            raise ValueError(
                f"participation_probs must have shape ({n_devices},), "
                f"got {pi.shape}")
        if np.any(pi <= 0.0) or np.any(pi > 1.0):
            raise ValueError(
                "participation_probs must lie in (0, 1] per device")
        if abs(float(pi.sum()) - s) > 1e-6 * s:
            raise ValueError(
                f"participation_probs must sum to clients_per_round={s}, "
                f"got sum {float(pi.sum()):.9g}")
    elif policy == "uniform":
        pi = np.full(n_devices, s / n_devices)
    elif policy == "channel":
        if lambdas is None:
            raise ValueError(
                "participation='channel' needs the deployment lambdas")
        pi = capped_proportional(np.asarray(lambdas, np.float64), s)
    elif policy in WEIGHTED_POLICIES:
        if weights is None:
            raise ValueError(
                f"participation={policy!r} needs its per-device weights "
                "(policy_weights(policy, task, dataset) — the "
                "trainer/engine derive them from their task/dataset)")
        pi = capped_proportional(np.asarray(weights, np.float64), s)
    else:   # "designed" without explicit probabilities
        raise ValueError(
            "participation='designed' needs explicit participation_probs "
            "(solve them with core.sca_jax.solve_participation_batch or "
            "the design-module wrappers)")
    return ResolvedParticipation(clients=s, policy=policy,
                                 probs=tuple(pi.tolist()))
