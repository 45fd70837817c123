"""Declarative scenario/sweep API of the port (counterpart of
``repro.api``), over the port's design solvers and FL engine:

    spec        ScenarioSpec / SweepSpec — pure-data experiment declarations
    plan        compile a sweep into cells + grouped batched design solves
    execute     run a plan into a versioned, content-hash-cached ResultSet
    results     result schema, strict JSON encoding, ResultSet artifact
    scenarios   named builders (paper figures, beyond-paper sweeps)
    cli         python -m repro_torch.api.cli run/list/describe

Specs, hashes and plans are the reference's, so a port result and a
reference result of one spec carry the same cell hash. ``execute`` runs
on the card unless given ``device="cpu"``.

Quick tour::

    from repro_torch.api import ScenarioSpec, SweepSpec, plan, execute
    sweep = SweepSpec(name="snr", base=ScenarioSpec(...),
                      axes={"wireless.tx_power_dbm": [-10, 0, 10]})
    print(plan(sweep).describe())       # cells + one batched design solve
    rs = execute(sweep)                 # cached, manifest-tracked
"""
from .execute import execute
from .plan import Cell, DesignGroup, Plan, plan
from .results import (SCHEMA_VERSION, CellResult, ResultSet, dump_json,
                      json_default, log_record, result_payload)
from .spec import (DataSpec, DesignPolicy, RunSpec, ScenarioSpec, SweepSpec,
                   TaskSpec, as_sweep, spec_from_dict, spec_hash)

__all__ = [
    "SCHEMA_VERSION", "Cell", "CellResult", "DataSpec", "DesignGroup",
    "DesignPolicy", "Plan", "ResultSet", "RunSpec", "ScenarioSpec",
    "SweepSpec", "TaskSpec", "as_sweep", "dump_json", "execute",
    "json_default", "log_record", "plan", "result_payload",
    "spec_from_dict", "spec_hash",
]
