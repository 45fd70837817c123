"""Materialize declarative specs into live objects (tasks, data, designs)
(counterpart of ``repro.api.materialize``).

The bridge between the pure-data ``ScenarioSpec`` layer and the port:
builds datasets and partitions, tasks and wireless deployments,
estimates the heterogeneity constant kappa on the task's own data (on the
device), constructs the Sec.-IV design-problem specs, and runs the
per-scheme tuned Monte-Carlo protocol through ``FLTrainer``.

Every entry point takes ``device`` (default ``None``: the card; raises
without one) and threads it to the kappa estimate, the co-design solvers
and the trainer. Nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import async_fl, digital_design, ota_design, sca_torch
from ..core.bounds import ObjectiveWeights
from ..core.channel import Deployment, make_deployment
from ..core.faults import effective_lambdas, survival_prob
from ..data.loader import FLDataset
from ..data.partition import partition_by_class
from ..data.synthetic import SyntheticSpec, make_classification_dataset
from ..device import resolve_device
from ..fl.tasks import MLPTask, SoftmaxRegressionTask
from ..fl.trainer import FLTrainer, solve_w_star
from .spec import ScenarioSpec


# --------------------------------------------------------------- setup

def build_task(spec: ScenarioSpec):
    t = spec.task
    if t.kind == "softmax":
        return SoftmaxRegressionTask(n_features=t.n_features,
                                     n_classes=t.n_classes, mu=t.mu,
                                     g_max=t.g_max)
    if t.kind == "mlp":
        return MLPTask(n_features=t.n_features, hidden=t.hidden,
                       n_classes=t.n_classes, mu_nc=t.mu, g_max=t.g_max)
    raise ValueError(f"unknown task kind {t.kind!r}")


def build_dataset(spec: ScenarioSpec) -> FLDataset:
    d = spec.data
    syn = SyntheticSpec(name=d.name, image_shape=tuple(d.image_shape),
                        n_train_per_class=d.n_train_per_class,
                        n_test_per_class=d.n_test_per_class,
                        noise_sigma=d.noise_sigma, seed=d.dataset_seed)
    x_tr, y_tr, x_te, y_te = make_classification_dataset(syn)
    shards = partition_by_class(x_tr, y_tr, spec.n_devices,
                                d.classes_per_device, d.samples_per_device,
                                seed=d.partition_seed)
    return FLDataset.from_shards(shards, x_te, y_te)


def build_deployment(spec: ScenarioSpec) -> Deployment:
    return make_deployment(spec.wireless)


def resolve_eta_max(spec: ScenarioSpec, task) -> float:
    if spec.run.eta_max is not None:
        return float(spec.run.eta_max)
    if spec.task.kind == "softmax":
        return 2.0 / (task.mu + task.smooth_l)
    raise ValueError("run.eta_max is required for non-softmax tasks "
                     "(no closed-form 2/(mu+L) rule)")


# -------------------------------------------------- kappa estimation

def _stacked(ds: FLDataset, dev: torch.device):
    """Device data as (N, n, F) f32 and (N, n) int64 tensors."""
    xs = np.stack([d.x for d in ds.devices]).astype(np.float32)
    ys = np.stack([d.y for d in ds.devices]).astype(np.int64)
    return (torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev))


def estimate_kappa_sc(task, ds, iters: int = 1500, device=None) -> float:
    """kappa_sc^2 = (1/N) sum ||grad f_m(w*)||^2, with w* from full GD
    (``solve_w_star``), on ``device``. The device gradients are f32 from
    the f32-cast w*, the norms f64."""
    dev = resolve_device(device)
    x_all = np.concatenate([d.x for d in ds.devices])
    y_all = np.concatenate([d.y for d in ds.devices])
    w_star = solve_w_star(task, x_all, y_all, iters=iters, device=dev)
    xs, ys = _stacked(ds, dev)
    g = task.device_grads(w_star.to(torch.float32), xs, ys).to(torch.float64)
    sq = torch.linalg.vector_norm(g, dim=1) ** 2
    return float(torch.sqrt(torch.mean(sq)))


def estimate_kappa_nc(task, ds, n_probes: int = 3, device=None) -> float:
    """kappa_nc: the gradient dissimilarity's maximum over ``n_probes``
    initial points (seeds 100, 101, ...), on ``device``."""
    dev = resolve_device(device)
    xs, ys = _stacked(ds, dev)
    worst = 0.0
    for i in range(n_probes):
        w = task.init_params(seed=100 + i, device=dev)
        g = task.device_grads(w.to(torch.float32), xs, ys).to(torch.float64)
        gbar = g.mean(dim=0, keepdim=True)
        worst = max(worst, float(torch.sqrt(
            torch.mean(torch.sum((g - gbar) ** 2, dim=1)))))
    return worst


def resolve_kappa(spec: ScenarioSpec, task, ds, device=None) -> float:
    pol = spec.design
    if pol.kappa is not None:
        return float(pol.kappa)
    if pol.objective == "strongly_convex":
        return estimate_kappa_sc(task, ds, iters=pol.kappa_iters,
                                 device=device)
    return estimate_kappa_nc(task, ds, n_probes=pol.kappa_probes,
                             device=device)


def design_weights(spec: ScenarioSpec, *, eta_max: float,
                   kappa: float, n_devices: int) -> ObjectiveWeights:
    """Footnote-4 weights at the scenario's operating point, omega-scaled."""
    pol = spec.design
    if pol.objective == "strongly_convex":
        w = ObjectiveWeights.strongly_convex(eta=eta_max, mu=spec.task.mu,
                                             kappa_sc=kappa, n=n_devices)
    elif pol.objective == "non_convex":
        w = ObjectiveWeights.non_convex(eta=eta_max, smooth_l=pol.smooth_l,
                                        kappa_nc=kappa, n=n_devices)
    else:
        raise ValueError(f"unknown design objective {pol.objective!r}")
    return ObjectiveWeights(omega_var=w.omega_var * pol.omega_var_scale,
                            omega_bias=w.omega_bias * pol.omega_bias_scale)


# ------------------------------------------------- materialized context

@dataclasses.dataclass
class CellContext:
    """Live objects of one scenario cell, ready to build schemes against.

    Design parameters (``ota_params``/``dig_params`` + direct variants)
    are filled in by the executor after the grouped batched solves;
    materialization itself never calls a design solver. ``device`` is
    where the cell's solvers and trainers run.
    """

    scenario: ScenarioSpec
    task: object
    ds: FLDataset
    dep: Deployment
    eta_max: float
    kappa: float
    weights: ObjectiveWeights
    device: torch.device
    ota_params: Optional[object] = None
    ota_objective: Optional[float] = None
    ota_params_direct: Optional[object] = None
    ota_objective_direct: Optional[float] = None
    dig_params: Optional[object] = None
    dig_objective: Optional[float] = None
    dig_params_direct: Optional[object] = None
    dig_objective_direct: Optional[float] = None

    @property
    def top_k(self) -> int:
        return self.scenario.design.top_k

    def design_spec(self, family: str):
        """The Sec.-IV design-problem spec of one family for this cell,
        on the fault layer's outage-adjusted channel energies
        (``core.faults.effective_lambdas``; the identity without
        faults)."""
        cfg = self.dep.cfg
        lam = effective_lambdas(self.dep.lambdas, self.scenario.fault)
        if family == "ota":
            return ota_design.OTADesignSpec(
                lambdas=lam, dim=self.task.dim,
                g_max=self.task.g_max, e_s=cfg.energy_per_symbol,
                n0=cfg.noise_power, weights=self.weights)
        if family == "digital":
            return digital_design.DigitalDesignSpec(
                lambdas=lam, dim=self.task.dim,
                g_max=self.task.g_max, e_s=cfg.energy_per_symbol,
                n0=cfg.noise_power, bandwidth_hz=cfg.bandwidth_hz,
                t_max_s=self.scenario.design.t_max_s, weights=self.weights)
        raise ValueError(f"unknown design family {family!r}")

    def set_design(self, family: str, variant: str, params, objective):
        prefix = "ota" if family == "ota" else "dig"
        suffix = "_direct" if variant == "direct" else ""
        setattr(self, f"{prefix}_params{suffix}", params)
        setattr(self, f"{prefix}_objective{suffix}", float(objective))

    def _levels(self, agg) -> np.ndarray:
        """The scheme's participation levels p (uniform 1/N when it
        carries no wireless design)."""
        lam = self.dep.lambdas
        params = getattr(agg, "params", None)
        if params is not None and hasattr(params, "participation_levels"):
            return np.asarray(params.participation_levels(lam), np.float64)
        return np.full(lam.shape[0], 1.0 / lam.shape[0])

    def participation_probs(self, agg) -> Optional[np.ndarray]:
        """Co-designed sampling probabilities for one scheme, or None.
        Only ``run.participation == "designed"`` with a cohort size
        solves anything (``core.sca_torch.solve_participation_batch``,
        pricing p and the fault layer's survival q)."""
        run = self.scenario.run
        if run.clients_per_round is None or run.participation != "designed":
            return None
        q = survival_prob(self.scenario.fault, self.dep.lambdas)
        pi, _ = sca_torch.solve_participation_batch(
            self._levels(agg)[None], q[None], [run.clients_per_round],
            [self.weights.omega_var], [self.weights.omega_bias],
            device=self.device)
        return pi[0]

    def async_weights(self, agg) -> Optional[np.ndarray]:
        """Staleness-aware designed aggregation weights v, or None. Only
        ``run.mode == "async"`` with ``async_.weighting == "designed"``
        solves anything (``core.sca_torch.solve_async_batch``, pricing p,
        the delivery weights c and the expected staleness)."""
        run = self.scenario.run
        asp = self.scenario.async_
        if run.mode != "async" or asp.weighting != "designed":
            return None
        n = self.dep.n_devices
        c = async_fl.delivery_weight(asp, n)
        sbar = async_fl.expected_staleness(asp, n)
        v, _ = sca_torch.solve_async_batch(
            self._levels(agg)[None], c[None], sbar[None],
            [self.weights.omega_var], [self.weights.omega_bias],
            device=self.device)
        return v[0]


class _Memo:
    """Per-execute cache of expensive sub-materializations: the dataset
    keyed on the data spec and device count, the deployment on the
    wireless config, kappa on (task, data, estimator knobs). An SNR
    sweep builds its dataset and estimates kappa once."""

    def __init__(self):
        self._store: dict = {}

    def get(self, key, build):
        if key not in self._store:
            self._store[key] = build()
        return self._store[key]


def materialize(spec: ScenarioSpec, memo: Optional[_Memo] = None, *,
                device=None) -> CellContext:
    """Build the live setup of one cell (design params left unsolved),
    kappa estimated on ``device``."""
    dev = resolve_device(device)
    memo = memo if memo is not None else _Memo()
    task_key = ("task", tuple(sorted(dataclasses.asdict(spec.task).items())))
    task = memo.get(task_key, lambda: build_task(spec))
    data_key = ("data",
                tuple(sorted(dataclasses.asdict(spec.data).items())),
                spec.n_devices)
    ds = memo.get(data_key, lambda: build_dataset(spec))
    dep_key = ("dep", tuple(sorted(dataclasses.asdict(spec.wireless).items())))
    dep = memo.get(dep_key, lambda: build_deployment(spec))
    eta_max = resolve_eta_max(spec, task)
    pol = spec.design
    kappa_key = ("kappa", task_key, data_key, pol.objective, pol.kappa,
                 pol.kappa_iters, pol.kappa_probes)
    kappa = memo.get(kappa_key,
                     lambda: resolve_kappa(spec, task, ds, device=dev))
    weights = design_weights(spec, eta_max=eta_max, kappa=kappa,
                             n_devices=spec.n_devices)
    return CellContext(scenario=spec, task=task, ds=ds, dep=dep,
                       eta_max=eta_max, kappa=kappa, weights=weights,
                       device=dev)


new_memo = _Memo


# ------------------------------------------------------------ running

def tune_and_run(task, ds, dep, agg, *, eta_max, rounds, trials, eval_every,
                 seed=5, time_budget_s=None, etas=(1.0, 0.5, 0.25, 0.1),
                 backend="auto", batch_size=None, rng="replay",
                 payload_dtype="f32", fault=None, clients_per_round=None,
                 participation="uniform", participation_probs=None,
                 mode="sync", async_spec=None, async_weights=None,
                 device=None):
    """Per-scheme step-size grid search (paper Sec. V), then the full MC
    run, on ``device``.

    The probes run one trial each on an independent seed (``seed + 91``)
    and never feed the final run, so a single-point grid skips probing
    with an identical result; the first eta with the best mean accuracy
    over the last two evals wins, as in the reference.
    """
    def trainer(eta):
        return FLTrainer(task, ds, dep, eta=eta, batch_size=batch_size,
                         payload_dtype=payload_dtype, fault=fault,
                         clients_per_round=clients_per_round,
                         participation=participation,
                         participation_probs=participation_probs,
                         mode=mode, async_spec=async_spec,
                         async_weights=async_weights, device=device)

    if len(etas) == 1:
        best_eta = etas[0] * eta_max
    else:
        best_eta, best_acc = None, -1.0
        for frac in etas:
            probe = trainer(frac * eta_max).run(
                agg, rounds=rounds, trials=1,
                eval_every=max(rounds // 4, 1), seed=seed + 91,
                time_budget_s=time_budget_s, backend=backend, rng=rng)
            acc = float(probe.accuracy[:, -2:].mean())   # 2-pt avg vs MC noise
            if acc > best_acc:
                best_acc, best_eta = acc, frac * eta_max
    log = trainer(best_eta).run(agg, rounds=rounds, trials=trials,
                                eval_every=eval_every, seed=seed,
                                time_budget_s=time_budget_s,
                                backend=backend, rng=rng)
    return log, best_eta


def run_cell_scheme(ctx: CellContext, agg):
    """One scheme's tuned MC run under the cell's RunSpec."""
    r = ctx.scenario.run
    return tune_and_run(ctx.task, ctx.ds, ctx.dep, agg,
                        eta_max=ctx.eta_max, rounds=r.rounds,
                        trials=r.trials, eval_every=r.eval_every,
                        seed=r.seed, time_budget_s=r.time_budget_s,
                        etas=tuple(r.etas), backend=r.backend,
                        batch_size=r.batch_size, rng=r.rng,
                        payload_dtype=r.payload_dtype,
                        fault=ctx.scenario.fault,
                        clients_per_round=r.clients_per_round,
                        participation=r.participation,
                        participation_probs=ctx.participation_probs(agg),
                        mode=r.mode, async_spec=ctx.scenario.async_,
                        async_weights=ctx.async_weights(agg),
                        device=ctx.device)
