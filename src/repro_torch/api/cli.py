"""Scenario/sweep command line of the port:

    PYTHONPATH=src python -m repro_torch.api.cli list
    PYTHONPATH=src python -m repro_torch.api.cli describe fig2_ota_sc
    PYTHONPATH=src python -m repro_torch.api.cli run sweep_smoke [--out DIR]
    PYTHONPATH=src python -m repro_torch.api.cli run sweep_smoke --jobs 2
    PYTHONPATH=src python -m repro_torch.api.cli run fig2_batch
    PYTHONPATH=src python -m repro_torch.api.cli run my_sweep.json --full
    PYTHONPATH=src python -m repro_torch.api.cli run sweep_smoke --device cpu

``run``/``describe`` accept a registered name (``list`` shows them) or a
path to a JSON spec file (a ``ScenarioSpec`` dict, or a ``SweepSpec``
dict with ``base``/``axes``). ``run --expect-cached`` exits non-zero if
any cell actually computed — the CI guard that a re-run of a finished
sweep is a cache no-op. ``run`` executes on the card unless ``--device``
names another device (``cpu``: the plain PyTorch path); without a card
the default raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import scenarios
from .execute import default_out_dir, execute
from .plan import plan
from .spec import spec_from_dict


def _load_spec(ref: str, *, quick: bool):
    if ref.endswith(".json") or "/" in ref:
        path = Path(ref)
        if not path.exists():
            raise SystemExit(f"spec file not found: {ref}")
        return spec_from_dict(json.loads(path.read_text()))
    try:
        return scenarios.get(ref, quick=quick)
    except KeyError:
        print(f"unknown scenario/sweep {ref!r}; registered:",
              file=sys.stderr)
        for name in scenarios.names():
            print(f"  {name}", file=sys.stderr)
        raise SystemExit(2)


def _cmd_list(_args) -> int:
    print("registered scenarios/sweeps (run/describe by name):")
    for name in scenarios.names():
        doc = (scenarios.REGISTRY[name].__doc__ or "").strip()
        first = doc.splitlines()[0] if doc else ""
        print(f"  {name:18s} {first}")
    return 0


def _cmd_describe(args) -> int:
    spec = _load_spec(args.spec, quick=not args.full)
    print(plan(spec).describe())
    return 0


def _cmd_run(args) -> int:
    spec = _load_spec(args.spec, quick=not args.full)
    pl = plan(spec)
    out_dir = Path(args.out) if args.out else default_out_dir(pl.name)
    rs = execute(pl, out_dir=out_dir, force=args.force, jobs=args.jobs,
                 cell_timeout_s=args.cell_timeout, retries=args.retries,
                 progress=lambda msg: print(msg, flush=True),
                 device=args.device)
    computed = sum(c.status == "computed" for c in rs.cells)
    cached = sum(c.status == "cached" for c in rs.cells)
    timeout = sum(c.status == "timeout" for c in rs.cells)
    extra = f", {timeout} timed out" if timeout else ""
    print(f"{rs.name}: {computed} computed, {cached} cached{extra} "
          f"-> {out_dir}")
    if args.expect_cached and computed:
        print(f"FAIL: --expect-cached but {computed} cell(s) recomputed "
              "(cache key drift?)", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api.cli",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="registered scenario/sweep names")

    p = sub.add_parser("describe",
                       help="print a spec's plan (cells, design groups)")
    p.add_argument("spec", help="registered name or JSON spec path")
    p.add_argument("--full", action="store_true",
                   help="paper-scale variant of a registered spec")

    p = sub.add_parser("run", help="execute a scenario/sweep")
    p.add_argument("spec", help="registered name or JSON spec path")
    p.add_argument("--out", default=None, help="ResultSet directory "
                   "(default experiments/results_torch/scenarios/<name>)")
    p.add_argument("--full", action="store_true",
                   help="paper-scale variant of a registered spec")
    p.add_argument("--force", action="store_true",
                   help="recompute cached cells")
    p.add_argument("--jobs", type=int, default=1, metavar="K",
                   help="run non-cached cells on a K-worker process pool "
                        "(same manifest and resume semantics as serial)")
    p.add_argument("--cell-timeout", type=float, default=None, metavar="S",
                   help="per-cell compute timeout on the worker pool; "
                        'exhausted cells finalize as status="timeout" '
                        "(parallel runs only)")
    p.add_argument("--retries", type=int, default=2, metavar="N",
                   help="extra attempts a timed-out or worker-crashed "
                        "cell gets before finalizing (default 2)")
    p.add_argument("--expect-cached", action="store_true",
                   help="exit 1 if any cell was (re)computed")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card; "
                        "'cpu' runs the plain PyTorch path)")

    args = ap.parse_args(argv)
    return {"list": _cmd_list, "describe": _cmd_describe,
            "run": _cmd_run}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
