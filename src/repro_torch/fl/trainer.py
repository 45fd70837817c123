"""FL training entry point (counterpart of ``repro.fl.trainer``).

Matches Sec. V's protocol: a fixed device deployment across trials,
independent fading and PS noise per trial, full-batch local gradients
(or SGD mini-batches of ``batch_size``, counter-based draws), projection
onto the ball {||w|| <= D/2} when ``project_radius`` is set, and
per-round latency accounting (OTA: d/B; digital: realized TDMA time),
with an optional wall-clock budget. Runs on the trials-batched engine
(``fl.engine.FLEngine``) on ``device`` (default: the card).

``FLTrainer`` takes the reference's arguments and hands the mini-batch,
fault, partial-participation, buffered-async and bf16-payload options to
the engine, which validates them with the reference's messages; each is
a strict no-op at its default. ``run(rng="fast")`` draws the fading, the
PS noise and the selection from the counter-based streams on the device
(the reference's fast mode); ``rng="replay"`` replays its NumPy streams.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.channel import Deployment
from ..device import resolve_device
from .engine import FLEngine, TrainLog


class FLTrainer:
    def __init__(self, task, dataset, deployment: Deployment,
                 eta: float, *, project_radius: Optional[float] = None,
                 batch_size: Optional[int] = None,
                 payload_dtype: str = "f32", fault=None,
                 clients_per_round: Optional[int] = None,
                 participation: str = "uniform",
                 participation_probs=None, mode: str = "sync",
                 async_spec=None, async_weights=None, device=None):
        self.eta = eta
        self.project_radius = project_radius
        self._engine = FLEngine(
            task, dataset, deployment, eta, project_radius=project_radius,
            batch_size=batch_size, payload_dtype=payload_dtype, fault=fault,
            clients_per_round=clients_per_round, participation=participation,
            participation_probs=participation_probs, mode=mode,
            async_spec=async_spec, async_weights=async_weights,
            device=device)

    def run(self, aggregator, *, rounds: int, trials: int = 3,
            eval_every: int = 10, seed: int = 0,
            w_star: Optional[np.ndarray] = None,
            time_budget_s: Optional[float] = None,
            backend: str = "auto", rng: str = "replay") -> TrainLog:
        """Run the Monte-Carlo FL protocol; the log's fields are the
        reference's (``repro.fl.trainer.TrainLog``). The port has one
        engine, so ``backend`` is "auto" only."""
        if backend != "auto":
            raise ValueError(
                f"backend={backend!r}: the port has one engine (FLEngine on "
                "the trainer's device); pass backend='auto'")
        if rng not in ("replay", "fast"):
            raise ValueError(f"rng must be 'replay' or 'fast', got {rng!r}")
        engine = self._engine
        # eta / radius may be retuned between runs (step-size searches)
        engine.eta, engine.project_radius = self.eta, self.project_radius
        return engine.run(aggregator, rounds=rounds, trials=trials,
                          eval_every=eval_every, seed=seed, w_star=w_star,
                          time_budget_s=time_budget_s, rng=rng)


def solve_w_star(task, x_all: np.ndarray, y_all: np.ndarray,
                 iters: int = 4000, eta: Optional[float] = None,
                 device=None) -> torch.Tensor:
    """Minimizer w* of the (strongly convex) global objective by
    full-batch GD, on ``device`` (default: the card): the iterate in f64,
    each gradient in f32 from the f32-cast iterate, widened to f64, as
    the reference's ``solve_w_star`` through its task. Returns the (d,)
    f64 iterate on the device."""
    dev = resolve_device(device)
    w = task.init_params(device=dev)
    eta = eta if eta is not None else 2.0 / (task.mu + task.smooth_l)
    xs = torch.as_tensor(np.asarray(x_all, np.float32), device=dev)[None]
    ys = torch.as_tensor(np.asarray(y_all, np.int64), device=dev)[None]
    for _ in range(iters):
        g = task.device_grads(w.to(torch.float32), xs, ys)[0]
        w = w - eta * g.to(torch.float64)
    return w
