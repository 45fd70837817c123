"""Named scenario/sweep builders: the paper figures + beyond-paper sweeps
(counterpart of ``repro.api.scenarios``).

Each builder returns the reference's pure-data ``ScenarioSpec``/
``SweepSpec`` (same seeds, sizes, suites, tuning grids, hence the same
``spec_hash``). ``REGISTRY`` backs the CLI
(``python -m repro_torch.api.cli run/list/describe``).
"""
from __future__ import annotations

from ..core.async_fl import AsyncSpec
from ..core.channel import WirelessConfig
from ..core.faults import FaultSpec
from .spec import (DataSpec, DesignPolicy, RunSpec, ScenarioSpec, SweepSpec,
                   TaskSpec)


def fig2_ota_sc(quick: bool = True, n_devices: int = 50) -> ScenarioSpec:
    """Paper Fig. 2a/2b: strongly convex OTA-FL comparison (Sec. V-A-1)."""
    return ScenarioSpec(
        name="fig2_ota_sc",
        data=DataSpec(
            n_train_per_class=((n_devices * 300) // 10 if quick else 6000),
            samples_per_device=300 if quick else 1000),
        wireless=WirelessConfig(n_devices=n_devices, seed=1),
        design=DesignPolicy(),
        run=RunSpec(rounds=80 if quick else 300, trials=2 if quick else 4,
                    eval_every=10,
                    etas=(1.0, 0.25) if quick else (1.0, 0.5, 0.25, 0.1)),
        schemes=("suite:fig2_ota",))


def fig2_digital_sc(quick: bool = True, n_devices: int = 10) -> ScenarioSpec:
    """Paper Fig. 2c/2d: digital FL vs wall-clock latency (Sec. V-A-2)."""
    return ScenarioSpec(
        name="fig2_digital_sc",
        data=DataSpec(n_train_per_class=600 if quick else 1200,
                      samples_per_device=300 if quick else 1000),
        wireless=WirelessConfig(n_devices=n_devices, seed=1),
        design=DesignPolicy(t_max_s=0.2),
        run=RunSpec(rounds=400 if quick else 1500,
                    trials=2 if quick else 4, eval_every=20,
                    time_budget_s=40.0 if quick else 150.0,
                    etas=(1.0, 0.25) if quick else (1.0, 0.5, 0.25, 0.1)),
        schemes=("suite:fig2_digital",))


def fig3_nonconvex(quick: bool = True, n_devices: int = 10) -> ScenarioSpec:
    """Paper Fig. 3: non-convex OTA-FL (MLP, two classes/device)."""
    return ScenarioSpec(
        name="fig3_nonconvex",
        task=TaskSpec(kind="mlp", n_features=3072, hidden=48, mu=0.01,
                      g_max=49.0),
        data=DataSpec(name="cifar-like", image_shape=(32, 32, 3),
                      n_train_per_class=120, n_test_per_class=100,
                      noise_sigma=1.8, dataset_seed=7,
                      classes_per_device=2, samples_per_device=100,
                      partition_seed=5),
        wireless=WirelessConfig(n_devices=n_devices, seed=1),
        design=DesignPolicy(objective="non_convex", smooth_l=10.0),
        run=RunSpec(rounds=100 if quick else 400, trials=2 if quick else 3,
                    eval_every=10, seed=9, eta_max=0.08,
                    etas=(1.0, 0.5) if quick else (1.5, 1.0, 0.5, 0.25)),
        schemes=("suite:fig3_ota",))


def snr_het(quick: bool = True, n_devices: int = 10) -> SweepSpec:
    """Beyond-paper workload: SNR x path-loss-heterogeneity sweep.

    Compares the proposed biased OTA and digital schemes against their
    zero-bias baselines (Vanilla OTA-FL; proportional-fairness selection)
    over a grid of transmit power (SNR) and path-loss exponent
    (heterogeneity level) — the benchmark axes of the OTA-FL literature
    (Zhu et al.; Sery et al.). The whole grid's Sec.-IV designs solve as
    one batched solve per scheme family.
    """
    base = ScenarioSpec(
        name="snr_het",
        data=DataSpec(n_train_per_class=300 if quick else 1200,
                      samples_per_device=150 if quick else 600),
        wireless=WirelessConfig(n_devices=n_devices, seed=1),
        design=DesignPolicy(t_max_s=0.2),
        run=RunSpec(rounds=60 if quick else 200, trials=2,
                    eval_every=10, etas=(1.0, 0.25)),
        schemes=("ideal", "proposed_ota", "vanilla_ota",
                 "proposed_digital", "prop_fairness"))
    if quick:
        axes = {"wireless.tx_power_dbm": (-5.0, 5.0),
                "wireless.pl_exponent": (2.2, 2.6)}
    else:
        axes = {"wireless.tx_power_dbm": (-10.0, 0.0, 10.0),
                "wireless.pl_exponent": (2.0, 2.2, 2.6)}
    return SweepSpec(name="snr_het", base=base, axes=axes)


def sweep_smoke(quick: bool = True) -> SweepSpec:
    """CI smoke: a 2x2 SNR x omega_bias sweep at toy scale (~1 min).

    Exercises the whole scenario layer — planning, one batched design
    solve for the grid, engine-backed runs, manifest + content-hash cache
    — with fixed kappa (no estimation) and a single-point eta grid.
    """
    base = ScenarioSpec(
        name="sweep_smoke",
        data=DataSpec(n_train_per_class=60, n_test_per_class=30,
                      samples_per_device=60),
        wireless=WirelessConfig(n_devices=6, seed=1),
        design=DesignPolicy(kappa=3.0),
        run=RunSpec(rounds=8, trials=1, eval_every=4, etas=(1.0,)),
        schemes=("proposed_ota", "vanilla_ota"))
    return SweepSpec(name="sweep_smoke", base=base,
                     axes={"wireless.tx_power_dbm": (-3.0, 3.0),
                           "design.omega_bias_scale": (0.5, 2.0)})


def sweep_fault(quick: bool = True, n_devices: int = 10) -> SweepSpec:
    """Fault injection: outage rate x heterogeneity grid (``core.faults``).

    Sweeps the per-round dropout probability against the path-loss
    exponent (heterogeneity level), with a deep-fade cutoff active
    throughout, comparing the proposed biased OTA design — whose solver
    sees the outage-adjusted effective channel statistics — against the
    zero-bias Vanilla OTA baseline. The thesis cell-by-cell: biased
    designs degrade gracefully with rising fault rates where zero-bias
    aggregation collapses.
    """
    base = ScenarioSpec(
        name="sweep_fault",
        data=DataSpec(n_train_per_class=60 if quick else 600,
                      n_test_per_class=30 if quick else 200,
                      samples_per_device=60 if quick else 300),
        wireless=WirelessConfig(n_devices=6 if quick else n_devices, seed=1),
        design=DesignPolicy(kappa=3.0 if quick else None),
        run=RunSpec(rounds=8 if quick else 100, trials=1 if quick else 2,
                    eval_every=4 if quick else 10,
                    etas=(1.0,) if quick else (1.0, 0.25)),
        fault=FaultSpec(deep_fade_thresh=1e-6, on_missing="reweight"),
        schemes=("proposed_ota", "vanilla_ota"))
    if quick:
        axes = {"fault.dropout_prob": (0.0, 0.3),
                "wireless.pl_exponent": (2.2, 2.6)}
    else:
        axes = {"fault.dropout_prob": (0.0, 0.2, 0.5),
                "wireless.pl_exponent": (2.0, 2.2, 2.6)}
    return SweepSpec(name="sweep_fault", base=base, axes=axes)


def sweep_participation(quick: bool = True, n_devices: int = 50) -> SweepSpec:
    """Partial participation: N x S grid, uniform vs co-designed sampling.

    Every cell runs under heterogeneous channel-dependent deep fades with
    ``on_missing="zero"`` (each device holds ONE class, so a device that
    rarely delivers drags the model away from its class — a structured
    bias), sampling an expected S = ``run.clients_per_round`` devices per
    round. The axes compare the zero-bias ``"uniform"`` policy (pi = S/N)
    against the bound-driven ``"designed"`` policy at the SAME S — equal
    expected airtime — where the capped-simplex solver
    (``core.sca_torch.solve_participation_batch``) tilts pi toward the
    devices that actually deliver, buying post-normalization SNR with a
    priced sampling bias. The cells sit at the variance-limited
    operating point (``omega_bias_scale`` shrinks the footnote-4 bias
    weight — the declared bias-variance trade-off axis): there the
    extra delivered mass outweighs the tilt, and designed sampling
    strictly beats uniform at equal airtime.
    """
    base = ScenarioSpec(
        name="sweep_participation",
        data=DataSpec(n_train_per_class=80 if quick else 600,
                      n_test_per_class=30 if quick else 200,
                      samples_per_device=60 if quick else 120),
        wireless=WirelessConfig(n_devices=12 if quick else n_devices,
                                seed=1, pl_exponent=2.6,
                                tx_power_dbm=10.0),
        design=DesignPolicy(kappa=3.0 if quick else None,
                            omega_bias_scale=1e-4),
        run=RunSpec(rounds=20 if quick else 100, trials=2,
                    eval_every=5 if quick else 10,
                    etas=(1.0,) if quick else (1.0, 0.25),
                    clients_per_round=6),
        fault=FaultSpec(deep_fade_thresh=4.5e-7, on_missing="zero"),
        schemes=("proposed_ota", "vanilla_ota"))
    if quick:
        axes = {"wireless.n_devices": (8, 12),
                "run.clients_per_round": (4, 8),
                "run.participation": ("uniform", "designed")}
    else:
        axes = {"wireless.n_devices": (max(n_devices // 2, 2), n_devices),
                "run.clients_per_round": (8, 16),
                "run.participation": ("uniform", "designed")}
    return SweepSpec(name="sweep_participation", base=base, axes=axes)


def sweep_async(quick: bool = True, n_devices: int = 10) -> SweepSpec:
    """Buffered-async FL: arrival-het x buffer x discount grid
    (``core.async_fl``), staleness-priced design point.

    Every cell runs ``run.mode="async"``: devices deliver their round-t
    gradient with heterogeneous per-round arrival probabilities r_m
    (``async_.arrival_rate`` spread by ``async_.rate_heterogeneity``;
    each device holds ONE class, so a slow-arriving device starves its
    class — a structured bias), late updates land from a last-K
    staleness buffer (``async_.buffer_rounds``) discounted by
    ``delta^staleness`` (``async_.staleness_discount``), and the PS
    applies the bound-driven aggregation weights v from
    ``core.sca_torch.solve_async_batch`` (``async_.weighting="designed"``)
    that re-balance the effective participation p_m * c_m * v_m the
    Theorem-1/2 bound prices (``bounds.async_effective_participation``).
    """
    base = ScenarioSpec(
        name="sweep_async",
        data=DataSpec(n_train_per_class=80 if quick else 600,
                      n_test_per_class=30 if quick else 200,
                      samples_per_device=60 if quick else 120),
        wireless=WirelessConfig(n_devices=8 if quick else n_devices,
                                seed=1, pl_exponent=2.2, tx_power_dbm=10.0),
        design=DesignPolicy(kappa=3.0 if quick else None),
        run=RunSpec(rounds=24 if quick else 100, trials=2,
                    eval_every=6 if quick else 10,
                    etas=(1.0,) if quick else (1.0, 0.25),
                    mode="async"),
        async_=AsyncSpec(buffer_rounds=4, arrival_rate=0.55,
                         rate_heterogeneity=3.0, staleness_discount=0.8,
                         on_missing="zero", weighting="designed"),
        schemes=("proposed_ota",))
    if quick:
        axes = {"async_.rate_heterogeneity": (1.0, 3.0),
                "async_.buffer_rounds": (2, 5),
                "async_.staleness_discount": (0.7, 1.0)}
    else:
        axes = {"async_.rate_heterogeneity": (0.5, 1.5, 3.0),
                "async_.buffer_rounds": (2, 4, 8),
                "async_.staleness_discount": (0.6, 0.8, 1.0)}
    return SweepSpec(name="sweep_async", base=base, axes=axes)


def fig2_batch(quick: bool = True, n_devices: int = 50) -> SweepSpec:
    """Fig. 2a/2b protocol over a ``run.batch_size`` grid (SGD scale).

    The paper's Monte-Carlo uses full-batch device gradients; this sweep
    re-runs the Fig.-2 OTA comparison with minibatch SGD at increasing
    batch sizes (None = full batch) to show the designed bias-variance
    trade-off is preserved under gradient noise — one ``cli run
    fig2_batch`` away instead of a hand-rolled loop.
    """
    base = fig2_ota_sc(quick=quick, n_devices=n_devices).replace(
        name="fig2_batch")
    sizes = (16, 64, None) if quick else (16, 64, 256, None)
    return SweepSpec(name="fig2_batch", base=base,
                     axes={"run.batch_size": sizes})


REGISTRY = {
    "fig2_ota_sc": fig2_ota_sc,
    "fig2_digital_sc": fig2_digital_sc,
    "fig3_nonconvex": fig3_nonconvex,
    "snr_het": snr_het,
    "sweep_smoke": sweep_smoke,
    "sweep_fault": sweep_fault,
    "sweep_participation": sweep_participation,
    "sweep_async": sweep_async,
    "fig2_batch": fig2_batch,
}


def names() -> list[str]:
    return sorted(REGISTRY)


def get(name: str, *, quick: bool = True):
    if name not in REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; registered: {names()}")
    return REGISTRY[name](quick=quick)
