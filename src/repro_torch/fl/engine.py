"""Monte-Carlo FL simulation engine (counterpart of ``repro.fl.engine``).

Runs the paper's (trials, rounds) recursion of eq. (2)/(13) with trials
as the leading dimension of every tensor (the reference's ``vmap``) and
rounds as a Python loop (its ``lax.scan``). Each round: f32 device
gradients of the f64 model, one scheme round (the OTA epilogue and the
digital quantizer run as CUDA kernels on the card), then the projected
f64 SGD step. The eval-segment structure and the time-budget freeze are
the reference's (``repro/fl/engine.py:746-907``): cumulative wall-clock
rides per trial, a round runs iff the wall-clock before it is under the
budget, and each eval reports the last live model.

Random streams replay the reference's ``rng="replay"`` mode bit for bit:
fading from ``channel.sample_fading_batch(lambdas, seed*1000 + trial, T)``,
PS AWGN from ``trial_rng(seed, trial).standard_normal((T, d))`` (both
NumPy, made on the host and copied to the device once per run), and
dither from the counter-based threefry stream ``rngstream.dither_blocks``
(one (trials, N, d) block per round, made on the device).

This slice covers sync mode, replay, full batches and four schemes
(IdealFedAvg, ProposedOTA, VanillaOTA, ProposedDigital); the options it
does not support raise ``NotImplementedError`` naming the ROADMAP item
that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import baselines as B
from ..core import rngstream
from ..core.channel import Deployment, sample_fading_batch
from ..core.digital import digital_round
from ..core.ota import ota_round
from ..device import resolve_device
from ..kernels import ops

_LATER = "ROADMAP Queue 1 item 9 (engine layers off the main path)"


@dataclasses.dataclass
class TrainLog:
    scheme: str
    rounds: np.ndarray          # (T_eval,)
    wall_time_s: np.ndarray     # cumulative uplink latency at eval points
    global_loss: np.ndarray     # (trials, T_eval)
    accuracy: np.ndarray        # (trials, T_eval)
    opt_error: Optional[np.ndarray] = None   # ||w_t - w*||^2 if w* known

    def final_accuracy(self) -> float:
        return float(self.accuracy[:, -1].mean())


@dataclasses.dataclass
class SchemePort:
    """A scheme in functional form: ``round_fn(grads (K,N,d) f64,
    habs (K,N), z01 (K,d) or None, u (K,N,d) f32 or None) -> (ghat (K,d),
    latency)``; latency in channel uses for OTA schemes (divided by the
    bandwidth by the engine), in seconds for digital ones."""

    name: str
    is_ota: bool
    round_fn: Callable
    needs_noise: bool = True
    needs_dither: bool = False


def scheme_port(agg, use_kernel: bool = True) -> SchemePort:
    """The engine's round function for a ``core.baselines`` scheme
    (counterparts of ``repro/fl/engine.py:183-310``)."""
    if isinstance(agg, B.IdealFedAvg):
        return SchemePort(agg.name, True,
                          lambda g, habs, z01, u: (g.mean(-2), 0.0),
                          needs_noise=False)
    if isinstance(agg, B.ProposedOTA):
        params = agg.params

        def ota_fn(g, habs, z01, u):
            ghat, _ = ota_round(params, g, habs, z01, use_kernel=use_kernel)
            return ghat, float(params.dim)

        return SchemePort(agg.name, True, ota_fn)
    if isinstance(agg, B.VanillaOTA):
        root_des = float(np.sqrt(agg.dim * agg.e_s))
        root_n0 = float(np.sqrt(agg.n0))

        def vanilla_fn(g, habs, z01, u):
            # per-trial gamma_t: the epilogue takes one inv_alpha per row
            gamma_t = root_des * habs.amin(-1) / agg.g_max
            acc = gamma_t[:, None] * g.sum(-2)
            ghat = ops.ota_combine_with_noise(acc, g.shape[-2] * gamma_t,
                                              root_n0 * z01,
                                              use_kernel=use_kernel)
            return ghat, float(agg.dim)

        return SchemePort(agg.name, True, vanilla_fn)
    if isinstance(agg, B.ProposedDigital):
        params = agg.params

        def digital_fn(g, habs, z01, u):
            ghat, _, latency = digital_round(params, g, habs, u,
                                             use_kernel=use_kernel)
            return ghat, latency

        return SchemePort(agg.name, False, digital_fn, needs_noise=False,
                          needs_dither=True)
    raise NotImplementedError(
        f"no port of scheme {type(agg).__name__} yet: the remaining Sec. V "
        "baselines arrive with ROADMAP Queue 1 item 6")


def _project(w: torch.Tensor, radius: float) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    return w * torch.clamp(radius / torch.clamp(nrm, min=1e-300), max=1.0)


def check_slice(*, batch_size=None, payload_dtype="f32", fault=None,
                clients_per_round=None, mode="sync", rng="replay") -> None:
    """Raise ``NotImplementedError`` for options outside this slice."""
    if fault is not None and not getattr(fault, "enabled", True):
        fault = None              # a disabled fault spec is no fault layer
    for opt, value, base in (("batch_size", batch_size, None),
                             ("payload_dtype", payload_dtype, "f32"),
                             ("fault", fault, None),
                             ("clients_per_round", clients_per_round, None),
                             ("mode", mode, "sync"),
                             ("rng", rng, "replay")):
        if value != base:
            raise NotImplementedError(
                f"{opt}={value!r} is not in the port's first slice (sync, "
                f"replay, full batch, f32 payloads); it arrives with "
                f"{_LATER}")


class FLEngine:
    """Trials-batched Monte-Carlo FL simulator on one device.

    Device data are stacked once: xs (N, n, F) f32, ys (N, n) int64.
    ``use_kernel=False`` runs the plain PyTorch versions of the kernels.
    """

    def __init__(self, task, dataset, deployment: Deployment, eta: float, *,
                 project_radius: Optional[float] = None,
                 batch_size: Optional[int] = None,
                 use_kernel: bool = True, payload_dtype: str = "f32",
                 fault=None, clients_per_round: Optional[int] = None,
                 mode: str = "sync", device=None):
        check_slice(batch_size=batch_size, payload_dtype=payload_dtype,
                    fault=fault, clients_per_round=clients_per_round,
                    mode=mode)
        sizes = {len(d) for d in dataset.devices}
        if len(sizes) != 1:
            raise ValueError("full-batch training needs equal-sized device "
                             f"datasets (got sizes {sorted(sizes)})")
        self.device = resolve_device(device)
        self.task = task
        self.dep = deployment
        self.eta = eta
        self.project_radius = project_radius
        self.use_kernel = use_kernel
        dev = self.device
        self.xs = torch.as_tensor(
            np.stack([d.x for d in dataset.devices]).astype(np.float32),
            device=dev)
        self.ys = torch.as_tensor(
            np.stack([d.y for d in dataset.devices]).astype(np.int64),
            device=dev)
        self.x_all = self.xs.reshape(-1, self.xs.shape[-1])
        self.y_all = self.ys.reshape(-1)
        self.x_test = torch.as_tensor(
            np.asarray(dataset.x_test, np.float32), device=dev)
        self.y_test = torch.as_tensor(
            np.asarray(dataset.y_test, np.int64), device=dev)

    def run(self, aggregator, *, rounds: int, trials: int = 3,
            eval_every: int = 10, seed: int = 0,
            w_star: Optional[np.ndarray] = None,
            time_budget_s: Optional[float] = None,
            rng: str = "replay") -> TrainLog:
        check_slice(rng=rng)
        port = scheme_port(aggregator, use_kernel=self.use_kernel)
        dev = self.device
        eval_rounds = list(range(0, rounds + 1, eval_every))
        n_seg = len(eval_rounds) - 1
        T = n_seg * eval_every      # rounds past the last eval are unobserved
        d, N = self.task.dim, self.dep.n_devices

        habs = torch.as_tensor(np.abs(np.stack(
            [sample_fading_batch(self.dep.lambdas, seed * 1000 + tr, T)
             for tr in range(trials)])), device=dev)          # (trials, T, N)
        Z = None
        if port.needs_noise:
            Z = torch.as_tensor(np.stack(
                [rngstream.trial_rng(seed, tr).standard_normal((T, d))
                 for tr in range(trials)]), device=dev)       # (trials, T, d)
        dkeys = [rngstream.dither_base_key(seed, tr) for tr in range(trials)]
        radius = (np.inf if self.project_radius is None
                  else float(self.project_radius))
        budget = np.inf if time_budget_s is None else float(time_budget_s)
        lat_div = self.dep.cfg.bandwidth_hz if port.is_ota else 1.0

        w = self.task.init_params(device=dev).expand(trials, d).clone()
        t_wall = torch.zeros(trials, dtype=torch.float64, device=dev)
        live = torch.ones(trials, dtype=torch.bool, device=dev)
        w_eval = w.clone()
        ws, walls = [w.clone()], [t_wall.clone()]
        for t in range(T):
            # a trial stops on the first round whose preceding cumulative
            # wall-clock reached the budget; its state freezes from there
            active = t_wall < budget
            g = self.task.device_grads(w.to(torch.float32), self.xs,
                                       self.ys).to(torch.float64)
            u = (rngstream.dither_blocks(dkeys, t, N, d, device=dev)
                 if port.needs_dither else None)
            ghat, lat = port.round_fn(g, habs[:, t],
                                      None if Z is None else Z[:, t], u)
            w = torch.where(active[:, None], _project(w - self.eta * ghat,
                                                      radius), w)
            # division (not a reciprocal multiply), as the reference
            t_wall = torch.where(active, t_wall + lat / lat_div, t_wall)
            live = active
            if (t + 1) % eval_every == 0:
                # the eval at a segment's end is written iff its last round
                # ran; otherwise the slot keeps the last written eval
                w_eval = torch.where(live[:, None], w, w_eval)
                ws.append(w_eval.clone())
                walls.append(t_wall.clone())
        W = torch.stack(ws, dim=1)                            # (trials, E, d)
        losses, accs = self._evaluate(W)
        opt_err = None
        if w_star is not None:
            w_np = W.cpu().numpy()
            opt_err = np.sum((w_np - np.asarray(w_star)) ** 2, axis=-1)
        return TrainLog(scheme=port.name,
                        rounds=np.asarray(eval_rounds, dtype=np.int64),
                        wall_time_s=torch.stack(walls, 1).mean(0).cpu().numpy(),
                        global_loss=losses, accuracy=accs,
                        opt_error=opt_err)

    def _evaluate(self, ws: torch.Tensor):
        """Global loss + test accuracy of every eval-point model, in the
        reference's float32 eval precision."""
        trials, E, d = ws.shape
        wf = ws.reshape(trials * E, d).to(torch.float32)
        losses = self.task.loss(wf, self.x_all, self.y_all)
        accs = self.task.accuracy(wf, self.x_test, self.y_test)
        return (losses.reshape(trials, E).to(torch.float64).cpu().numpy(),
                accs.reshape(trials, E).to(torch.float64).cpu().numpy())
