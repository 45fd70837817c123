"""Declarative experiment specs: ``ScenarioSpec`` and ``SweepSpec``
(counterpart of ``repro.api.spec``).

A ``ScenarioSpec`` is a pure-data description of one FL experiment cell:
task, data partition, wireless deployment, scheme suite, Sec.-IV design
policy and run options. It is JSON/dict round-trippable
(``to_dict``/``from_dict``), hashable by content (``spec_hash``), and
carries no arrays or live objects: datasets, designs and trainers are
materialized by ``api.materialize`` / ``api.execute``.

A ``SweepSpec`` declares grids over any spec axis by dotted path
(``wireless.tx_power_dbm``, ``design.omega_bias_scale``, ...) and
expands to the cross product of override-applied scenarios
(``points()``).

Every dataclass here has the reference's fields, order, defaults and
types, so ``spec_hash`` gives the reference's hash for the same spec and
the two packages' results can be compared by it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Optional

from ..core.async_fl import MODES, AsyncSpec
from ..core.channel import WirelessConfig
from ..core.faults import FaultSpec
from .results import SCHEMA_VERSION, json_default


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Learning task (Sec. V): softmax regression or the MLP stand-in."""

    kind: str = "softmax"            # "softmax" | "mlp"
    n_features: int = 784
    n_classes: int = 10
    hidden: int = 48                 # mlp only
    mu: float = 0.01                 # softmax: strong convexity; mlp: l2 reg
    g_max: float = 20.0              # Assumption 1 gradient clip


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Synthetic dataset + non-i.i.d. partition (Sec. V splits)."""

    name: str = "mnist-like"         # synthetic family ("mnist-like"/...)
    image_shape: tuple = (28, 28, 1)
    n_train_per_class: int = 1200
    n_test_per_class: int = 200
    noise_sigma: float = 1.5
    dataset_seed: int = 0
    classes_per_device: int = 1
    samples_per_device: int = 1000
    partition_seed: int = 3


@dataclasses.dataclass(frozen=True)
class DesignPolicy:
    """Sec.-IV bias-variance design knobs shared by every designed scheme.

    ``kappa=None`` estimates the heterogeneity constant from the actual
    task data (``estimate_kappa_sc``/``estimate_kappa_nc``); the omega
    scales multiply the footnote-4 weights, exposing the bias-variance
    trade-off as a sweepable axis.
    """

    objective: str = "strongly_convex"   # | "non_convex" (footnote 4 rule)
    kappa: Optional[float] = None        # None -> estimate on the data
    kappa_iters: int = 1500              # sc: GD iters for w* in estimation
    kappa_probes: int = 3                # nc: probe points
    smooth_l: float = 10.0               # nc: smoothness L in omega_var
    omega_var_scale: float = 1.0
    omega_bias_scale: float = 1.0
    t_max_s: float = 0.2                 # digital latency budget (17b)
    top_k: int = 4                       # digital selection baselines' K
    solver: str = "auto"                 # auto|jax|sca|scipy|direct


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Monte-Carlo run options (rounds/trials/tuning/backend)."""

    rounds: int = 100
    trials: int = 2
    eval_every: int = 10
    seed: int = 5
    etas: tuple = (1.0, 0.5, 0.25, 0.1)  # step-size grid, fractions of eta_max
    eta_max: Optional[float] = None      # None -> 2/(mu+L) (softmax rule)
    batch_size: Optional[int] = None     # None -> full batch (|B|=|D|)
    time_budget_s: Optional[float] = None
    backend: str = "auto"
    rng: str = "replay"                  # "replay" (oracle-exact) | "fast"
    payload_dtype: str = "f32"           # uplink gradient payload: f32|bf16
    clients_per_round: Optional[int] = None  # S: partial participation (off)
    participation: str = "uniform"       # uniform|channel|designed|loss|datasize
    mode: str = "sync"                   # "sync" | "async" (core.async_fl)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"run.mode must be one of {MODES}, got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative FL experiment cell (pure data, dict round-trippable).

    ``schemes`` lists scheme keys from ``api.schemes`` and/or
    ``"suite:<name>"`` aliases expanded in declaration order.
    """

    name: str = "scenario"
    task: TaskSpec = TaskSpec()
    data: DataSpec = DataSpec()
    wireless: WirelessConfig = WirelessConfig()
    design: DesignPolicy = DesignPolicy()
    run: RunSpec = RunSpec()
    fault: FaultSpec = FaultSpec()       # wireless fault injection (off)
    async_: AsyncSpec = AsyncSpec()      # buffered-async knobs (run.mode)
    schemes: tuple = ("suite:fig2_ota",)

    @property
    def n_devices(self) -> int:
        return self.wireless.n_devices

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        data = dict(d["data"])
        data["image_shape"] = tuple(data["image_shape"])
        run = dict(d["run"])
        run["etas"] = tuple(run["etas"])
        return cls(
            name=d["name"],
            task=TaskSpec(**d["task"]),
            data=DataSpec(**data),
            wireless=WirelessConfig(**d["wireless"]),
            design=DesignPolicy(**d["design"]),
            run=RunSpec(**run),
            # pre-v5 dicts have no "fault" key: default to disabled
            fault=FaultSpec(**d["fault"]) if d.get("fault") else FaultSpec(),
            # pre-v7 dicts have no "async_" key: default knobs (run.mode
            # also defaults to "sync" via RunSpec, keeping them inert)
            async_=(AsyncSpec(**d["async_"]) if d.get("async_")
                    else AsyncSpec()),
            schemes=tuple(d["schemes"]))

    def replace(self, **kw) -> "ScenarioSpec":
        return dataclasses.replace(self, **kw)

    def override(self, path: str, value) -> "ScenarioSpec":
        """Return a copy with the dotted-path field replaced."""
        return _apply_override(self, path, value)

    def spec_hash(self) -> str:
        return spec_hash(self.to_dict())


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A grid over scenario axes: base spec + ordered (path, values) axes."""

    name: str
    base: ScenarioSpec
    axes: tuple = ()                 # ((dotted_path, (v0, v1, ...)), ...)

    def __post_init__(self):
        # accept {path: values} mappings in declarations; normalize to the
        # ordered tuple-of-pairs form (dict insertion order preserved)
        if isinstance(self.axes, dict):
            object.__setattr__(self, "axes", tuple(
                (k, tuple(v)) for k, v in self.axes.items()))
        else:
            object.__setattr__(self, "axes", tuple(
                (k, tuple(v)) for k, v in self.axes))

    @property
    def shape(self) -> tuple:
        return tuple(len(vals) for _, vals in self.axes)

    @property
    def n_points(self) -> int:
        n = 1
        for _, vals in self.axes:
            n *= len(vals)
        return n

    def points(self) -> list[tuple[dict, ScenarioSpec]]:
        """Cross product of the axes: [(overrides, scenario), ...]."""
        paths = [p for p, _ in self.axes]
        grids = [vals for _, vals in self.axes]
        out = []
        for combo in itertools.product(*grids):
            overrides = dict(zip(paths, combo))
            sc = self.base
            for path, value in overrides.items():
                sc = _apply_override(sc, path, value)
            out.append((overrides, sc))
        return out

    def to_dict(self) -> dict:
        return {"name": self.name, "base": self.base.to_dict(),
                "axes": {p: list(v) for p, v in self.axes}}

    @classmethod
    def from_dict(cls, d: dict) -> "SweepSpec":
        return cls(name=d["name"], base=ScenarioSpec.from_dict(d["base"]),
                   axes=d.get("axes", ()))

    def spec_hash(self) -> str:
        return spec_hash(self.to_dict())


def as_sweep(spec) -> SweepSpec:
    """Promote a single scenario to a one-cell sweep (planner entry)."""
    if isinstance(spec, SweepSpec):
        return spec
    if isinstance(spec, ScenarioSpec):
        return SweepSpec(name=spec.name, base=spec, axes=())
    raise TypeError(f"expected ScenarioSpec or SweepSpec, got {type(spec)}")


def spec_from_dict(d: dict):
    """Dispatch a parsed JSON object to the matching spec class."""
    return SweepSpec.from_dict(d) if "base" in d else ScenarioSpec.from_dict(d)


def spec_hash(d: dict) -> str:
    """Content hash of a spec dict (cache key; schema-version salted).

    Serialized through the strict result encoder so numpy scalars in spec
    fields or sweep grids (np.arange/np.linspace axes) hash like their
    Python equivalents instead of raising.
    """
    canon = json.dumps({"schema_version": SCHEMA_VERSION, "spec": d},
                       sort_keys=True, separators=(",", ":"),
                       default=json_default)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def _apply_override(node, path: str, value):
    """Replace a (possibly nested) frozen-dataclass field by dotted path."""
    head, _, rest = path.partition(".")
    if not hasattr(node, head):
        raise KeyError(f"unknown spec field {head!r} in override {path!r}")
    if rest:
        value = _apply_override(getattr(node, head), rest, value)
    else:
        current = getattr(node, head)
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
    return dataclasses.replace(node, **{head: value})
