"""FL training entry point (counterpart of ``repro.fl.trainer.FLTrainer``).

Matches Sec. V's protocol: a fixed device deployment across trials,
independent fading and PS noise per trial, full-batch local gradients,
projection onto the ball {||w|| <= D/2} when ``project_radius`` is set,
and per-round latency accounting (OTA: d/B; digital: realized TDMA time),
with an optional wall-clock budget. Runs on the trials-batched engine
(``fl.engine.FLEngine``) on ``device`` (default: the card).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.channel import Deployment
from .engine import FLEngine, TrainLog


class FLTrainer:
    def __init__(self, task, dataset, deployment: Deployment,
                 eta: float, *, project_radius: Optional[float] = None,
                 batch_size: Optional[int] = None,
                 payload_dtype: str = "f32", fault=None,
                 clients_per_round: Optional[int] = None,
                 mode: str = "sync", device=None):
        self.eta = eta
        self.project_radius = project_radius
        self._engine = FLEngine(
            task, dataset, deployment, eta, project_radius=project_radius,
            batch_size=batch_size, payload_dtype=payload_dtype, fault=fault,
            clients_per_round=clients_per_round, mode=mode, device=device)

    def run(self, aggregator, *, rounds: int, trials: int = 3,
            eval_every: int = 10, seed: int = 0,
            w_star: Optional[np.ndarray] = None,
            time_budget_s: Optional[float] = None,
            rng: str = "replay") -> TrainLog:
        """Run the Monte-Carlo FL protocol; the log's fields are the
        reference's (``repro.fl.trainer.TrainLog``)."""
        engine = self._engine
        # eta / radius may be retuned between runs (step-size searches)
        engine.eta, engine.project_radius = self.eta, self.project_radius
        return engine.run(aggregator, rounds=rounds, trials=trials,
                          eval_every=eval_every, seed=seed, w_star=w_star,
                          time_budget_s=time_budget_s, rng=rng)
