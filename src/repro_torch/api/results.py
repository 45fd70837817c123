"""Result schema, strict JSON serialization, and the ``ResultSet`` artifact
(counterpart of ``repro.api.results``).

Every payload is stamped with ``schema_version`` (``result_payload``) and
serialized through a *strict* encoder: numpy scalars and arrays are
converted explicitly, anything else unknown raises instead of being
coerced. ``SCHEMA_VERSION`` is the reference's, so a cell's content hash
(``spec.spec_hash``) is the same in both packages and their results can
be compared cell by cell.

A ``ResultSet`` is the versioned on-disk artifact of one executed sweep:

    <dir>/manifest.json          sweep spec + hash, git rev, schema
                                 version, per-cell status/timings
    <dir>/cells/<hash>.json      one payload per scenario cell, keyed by
                                 the cell's content hash (the cache key)

The port writes under its own root, ``experiments/results_torch/``
(``REPRO_TORCH_RESULTS_DIR`` overrides it), never under the reference's
``experiments/results/``: equal hashes there would hand a reference
result back as the port's own.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

#: The reference's schema version (v7: ``RunSpec.mode`` and
#: ``ScenarioSpec.async_``); cached cells of another version are
#: recomputed, not reused.
SCHEMA_VERSION = 7

_REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_RESULTS_ROOT = Path(os.environ.get(
    "REPRO_TORCH_RESULTS_DIR", _REPO_ROOT / "experiments" / "results_torch"))


# ------------------------------------------------------- strict encoding

def json_default(obj):
    """Explicit JSON fallback: numpy scalars/arrays only, else TypeError."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(
        f"result payloads must be JSON-native (+ numpy scalars/arrays); "
        f"got {type(obj).__name__!r} — convert it explicitly")


def dump_json(payload: dict, *, indent: int = 1) -> str:
    return json.dumps(payload, indent=indent, default=json_default)


def result_payload(kind: str, **fields) -> dict:
    """Assemble a schema-stamped result payload (the one payload helper)."""
    return {"schema_version": SCHEMA_VERSION, "kind": kind, **fields}


def log_record(log, **extra) -> dict:
    """One ``TrainLog`` as a JSON record (mean/std over MC trials);
    ``extra`` merges additional fields (tuned eta, scheme key, timings)."""
    d = {
        "scheme": log.scheme,
        "rounds": np.asarray(log.rounds).tolist(),
        "wall_time_s": np.asarray(log.wall_time_s).tolist(),
        "loss_mean": log.global_loss.mean(0).tolist(),
        "loss_std": log.global_loss.std(0).tolist(),
        "acc_mean": log.accuracy.mean(0).tolist(),
        "acc_std": log.accuracy.std(0).tolist(),
    }
    if log.opt_error is not None:
        d["opt_err_mean"] = log.opt_error.mean(0).tolist()
    d.update(extra)
    return d


def git_rev() -> str:
    """Current git revision for result provenance ("unknown" outside git)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=_REPO_ROOT, timeout=10,
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ------------------------------------------------------------- ResultSet

@dataclasses.dataclass
class CellResult:
    """One scenario cell of an executed sweep."""

    index: int
    cell_hash: str
    overrides: dict               # sweep-axis values applied to the base
    status: str                   # "computed" | "cached" | "timeout"
    path: Optional[Path]          # cell payload file (None if unsaved)
    payload: dict

    @property
    def logs(self) -> list[dict]:
        return self.payload.get("logs", [])

    def log(self, scheme_key: str) -> dict:
        for rec in self.logs:
            if rec.get("scheme_key") == scheme_key or \
                    rec.get("scheme") == scheme_key:
                return rec
        raise KeyError(f"scheme {scheme_key!r} not in cell {self.index}")


@dataclasses.dataclass
class ResultSet:
    """Versioned artifact of one executed scenario/sweep."""

    manifest: dict
    cells: list[CellResult]
    directory: Optional[Path] = None

    @property
    def name(self) -> str:
        return self.manifest["name"]

    @property
    def all_cached(self) -> bool:
        return all(c.status == "cached" for c in self.cells)

    def __iter__(self) -> Iterator[CellResult]:
        return iter(self.cells)

    def __len__(self) -> int:
        return len(self.cells)

    def cell(self, index: int) -> CellResult:
        return self.cells[index]

    def save(self, directory: Path) -> Path:
        """Write manifest + per-cell payloads (content-hash filenames).

        Cells already on disk at their target path are not re-serialized;
        cells without a payload (``status="timeout"``) are recorded in the
        manifest but get no payload file.
        """
        directory = Path(directory)
        (directory / "cells").mkdir(parents=True, exist_ok=True)
        for c in self.cells:
            if not c.payload:
                c.path = None
                continue
            path = directory / "cells" / f"{c.cell_hash}.json"
            if c.path != path or not path.exists():
                path.write_text(dump_json(c.payload))
            c.path = path
        (directory / "manifest.json").write_text(dump_json(self.manifest))
        self.directory = directory
        return directory

    @classmethod
    def load(cls, directory: Path) -> "ResultSet":
        directory = Path(directory)
        manifest = json.loads((directory / "manifest.json").read_text())
        cells = []
        for entry in manifest["cells"]:
            path = directory / "cells" / f"{entry['cell_hash']}.json"
            # timeout cells have no payload file; keep the manifest row
            has_payload = path.exists()
            cells.append(CellResult(
                index=entry["index"], cell_hash=entry["cell_hash"],
                overrides=entry.get("overrides", {}),
                status=entry.get("status", "cached"),
                path=path if has_payload else None,
                payload=json.loads(path.read_text()) if has_payload else {}))
        return cls(manifest=manifest, cells=cells, directory=directory)
