"""Sweep planner: compile a declarative spec into batched work
(counterpart of ``repro.api.plan``).

``plan()`` expands a ``ScenarioSpec``/``SweepSpec`` into scenario cells
(content-hashed — the executor's cache key) and groups the Sec.-IV design
work so a whole grid solves in single ``design_ota_batch`` /
``design_digital_batch`` calls: cells needing a designed scheme are
bucketed by (family, device count, solver), since the batched solvers
stack grid points of one N (``stack_*_specs``).

The plan is pure metadata: nothing is materialized or solved until
``api.execute.execute``. ``Plan.describe()`` prints the reference's text
character for character ("1 batched jit" names one batched solve, which
in the port is one float64 torch solve).
"""
from __future__ import annotations

import dataclasses

from . import schemes
from .spec import ScenarioSpec, SweepSpec, as_sweep, spec_hash


@dataclasses.dataclass(frozen=True)
class Cell:
    """One grid point: override-applied scenario + its content hash."""

    index: int
    overrides: dict
    scenario: ScenarioSpec
    cell_hash: str


@dataclasses.dataclass(frozen=True)
class DesignGroup:
    """One batched design solve: all member cells in a single call."""

    family: str                  # "ota" | "digital"
    n_devices: int
    solver: str                  # policy solver of the member cells
    cell_indices: tuple          # cells whose design spec joins this batch
    needs_direct: tuple          # subset also needing the per-point direct solve

    @property
    def batched(self) -> bool:
        """Whether the group is one batched solve (vs per-point SciPy
        calls for solver="sca"/"scipy"/"direct")."""
        return self.solver in ("auto", "jax")


@dataclasses.dataclass(frozen=True)
class Plan:
    sweep: SweepSpec
    cells: tuple                 # tuple[Cell, ...]
    design_groups: tuple         # tuple[DesignGroup, ...]

    @property
    def name(self) -> str:
        return self.sweep.name

    def describe(self) -> str:
        lines = [f"sweep {self.name!r}: {len(self.cells)} cell(s), "
                 f"hash {self.sweep.spec_hash()}"]
        for path, vals in self.sweep.axes:
            lines.append(f"  axis {path} = {list(vals)}")
        for c in self.cells:
            keys = schemes.expand_schemes(c.scenario.schemes)
            ov = ", ".join(f"{k}={v}" for k, v in c.overrides.items()) or "-"
            lines.append(f"  cell {c.index} [{c.cell_hash}] {ov} "
                         f"({len(keys)} schemes)")
        for g in self.design_groups:
            kind = ("1 batched jit" if g.batched
                    else f"{len(g.cell_indices)} per-point {g.solver} solves")
            lines.append(f"  design {g.family} (N={g.n_devices}): "
                         f"{len(g.cell_indices)} point(s) -> {kind}"
                         + (f", direct cross-check on {len(g.needs_direct)}"
                            if g.needs_direct else ""))
        return "\n".join(lines)

    def schedule(self) -> tuple:
        """Dependency-ordered work list: ``("design", group)`` /
        ``("cell", cell)`` entries, each design group placed immediately
        before its first member cell. Because a group's first member is
        its minimum cell index, *every* group a cell belongs to precedes
        that cell — so a walk in schedule order (serial executor) or a
        solve-then-dispatch walk (parallel executor) never reaches a cell
        whose batched design is still unsolved.
        """
        first: dict = {}
        for g in sorted(self.design_groups,
                        key=lambda g: (min(g.cell_indices), g.family)):
            first.setdefault(min(g.cell_indices), []).append(g)
        entries = []
        for cell in self.cells:
            for g in first.get(cell.index, ()):
                entries.append(("design", g))
            entries.append(("cell", cell))
        return tuple(entries)


def plan(spec) -> Plan:
    """Compile a scenario/sweep into cells + grouped design work."""
    sweep = as_sweep(spec)
    cells = []
    for i, (overrides, scenario) in enumerate(sweep.points()):
        cells.append(Cell(index=i, overrides=overrides, scenario=scenario,
                          cell_hash=spec_hash(scenario.to_dict())))

    groups: dict = {}
    for cell in cells:
        fams = schemes.design_families(cell.scenario.schemes)
        for family, needs_direct in fams.items():
            key = (family, cell.scenario.n_devices,
                   cell.scenario.design.solver)
            members, direct = groups.setdefault(key, ([], []))
            members.append(cell.index)
            if needs_direct:
                direct.append(cell.index)
    design_groups = tuple(
        DesignGroup(family=family, n_devices=n, solver=solver,
                    cell_indices=tuple(members), needs_direct=tuple(direct))
        for (family, n, solver), (members, direct) in groups.items())
    return Plan(sweep=sweep, cells=tuple(cells), design_groups=design_groups)
