"""Sweep executor: grouped batched design solves, cached cell runs
(counterpart of ``repro.api.execute``).

``execute()`` turns a plan into a versioned ``ResultSet`` on one device
(default: the card; ``device="cpu"`` runs the plain PyTorch path):

0. **Backend check** — a cell asking for another backend than the
   port's one engine is refused before anything is solved or written.
   Every run option of the reference runs: mini-batches (``fig2_batch``),
   ``rng="fast"``, the fault, participation, async and bf16-payload
   layers.
1. **Cache check** — each cell's content hash (spec + schema version) is
   looked up under ``<out_dir>/cells/<hash>.json``; hits short-circuit the
   whole cell (no design solve, no simulation). The default ``out_dir``
   lies under the port's own results root, never the reference's.
2. **Grouped design** — the remaining cells' design problems solve as one
   ``design_ota_batch``/``design_digital_batch`` call per plan group
   (family x device count) on the device (``core.sca_torch``);
   "sca"/"scipy"/"direct" policies take the per-point SciPy solvers.
3. **Simulation** — every scheme runs through the tuned-MC protocol with
   ``FLTrainer.run`` (the kernels on the card).
4. **Artifact** — per-cell payloads + a manifest (sweep spec + hash, git
   rev, per-cell status/timings) land under ``out_dir``; re-running a
   half-finished sweep recomputes only the missing cells.

``execute(..., jobs=K)`` runs independent cells on a supervised pool of
``K`` persistent spawn workers, each opening its own context on the same
device: the main process does the cache check and the grouped design
solves, then ships each cell to a worker as pure data (the scenario dict,
the solved design parameters and the memoized kappa estimates). On a card
the main process builds every kernel first, so no worker compiles inside
its cell's timeout. Workers write ``cells/<hash>.json`` the moment a cell
finishes and errors are collected (not fail-fast), so a crashed parallel
sweep resumes like a serial one; the manifest equals the serial one but
for wall-clock timings. A worker that dies mid-cell gets its cell
requeued on a fresh worker with exponential backoff (``retries`` extra
attempts); a cell still running ``cell_timeout_s`` seconds after its
worker started it is killed and, once retries are exhausted, surfaces as
``status="timeout"`` with an empty payload. Deterministic Python
exceptions (a kernel that fails to launch among them) are never retried
and never rerun on another path.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

from ..core import digital_design, ota_design
from ..device import resolve_device
from . import materialize as mat
from . import schemes
from .plan import Cell, Plan, plan as make_plan
from .results import (DEFAULT_RESULTS_ROOT, SCHEMA_VERSION, CellResult,
                      ResultSet, dump_json, git_rev, log_record,
                      result_payload)
from .spec import ScenarioSpec


logger = logging.getLogger(__name__)


def default_out_dir(name: str) -> Path:
    return DEFAULT_RESULTS_ROOT / "scenarios" / name


def _load_cached(path: Path) -> Optional[dict]:
    if not path.exists():
        return None
    try:
        payload = json.loads(path.read_text())
    except json.JSONDecodeError:
        # corrupt cache cell (truncated write, disk hiccup): quarantine it
        # under <name>.json.bad so the evidence survives, and recompute
        bad = path.with_name(path.name + ".bad")
        try:
            path.replace(bad)
        except OSError:
            return None
        logger.warning("quarantined corrupt result cell %s -> %s; "
                       "the cell will be recomputed", path, bad.name)
        return None
    except OSError:
        return None
    if payload.get("schema_version") != SCHEMA_VERSION:
        return None
    return payload


def _check_supported(pl: Plan) -> None:
    """Refuse, before any solve or write, a plan whose cells ask for a
    backend the port does not have."""
    for cell in pl.cells:
        r = cell.scenario.run
        if r.backend != "auto":
            raise ValueError(
                f"cell {cell.index}: run.backend={r.backend!r}; the port "
                "has one engine, so backend is 'auto'")


def _solve_group(group, contexts, device) -> None:
    """One design group: a single batched call on ``device`` (or per-point
    SciPy solves)."""
    members = [contexts[i] for i in group.cell_indices]
    specs = [ctx.design_spec(group.family) for ctx in members]
    if group.family == "ota":
        batch, sca, direct = (ota_design.design_ota_batch,
                              ota_design.design_ota_sca,
                              ota_design.design_ota_direct)
    else:
        batch, sca, direct = (digital_design.design_digital_batch,
                              digital_design.design_digital_sca,
                              digital_design.design_digital_direct)
    if group.batched:
        params, objs = batch(specs, device=device)
        solved = list(zip(params, objs))
    elif group.solver in ("sca", "scipy"):
        solved = []
        for s in specs:
            p, res = sca(s, n_iters=8)
            solved.append((p, res.objective))
    elif group.solver == "direct":
        solved = [direct(s) for s in specs]
    else:
        raise ValueError(f"unknown design solver {group.solver!r}")
    for ctx, (p, obj) in zip(members, solved):
        ctx.set_design(group.family, "designed", p, obj)
        if group.solver == "direct":
            # the designed variant IS the direct solve; don't solve twice
            ctx.set_design(group.family, "direct", p, obj)
    if group.solver != "direct":
        for idx in group.needs_direct:
            ctx = contexts[idx]
            p, obj = direct(ctx.design_spec(group.family))
            ctx.set_design(group.family, "direct", p, obj)


def _run_cell(cell, ctx) -> dict:
    """All schemes of one cell through the tuned Monte-Carlo protocol."""
    scenario = ctx.scenario
    t0 = time.perf_counter()
    logs = []
    for key in schemes.expand_schemes(scenario.schemes):
        t1 = time.perf_counter()
        agg = schemes.build_scheme(key, ctx)
        log, best_eta = mat.run_cell_scheme(ctx, agg)
        logs.append(log_record(log, scheme_key=key, eta=best_eta,
                               elapsed_s=time.perf_counter() - t1))
    design = {}
    if ctx.ota_objective is not None:
        design["ota"] = {"objective": ctx.ota_objective,
                         "solver": scenario.design.solver}
        if ctx.ota_objective_direct is not None:
            design["ota"]["objective_direct"] = ctx.ota_objective_direct
    if ctx.dig_objective is not None:
        design["digital"] = {"objective": ctx.dig_objective,
                             "solver": scenario.design.solver}
        if ctx.dig_objective_direct is not None:
            design["digital"]["objective_direct"] = ctx.dig_objective_direct
    return result_payload(
        "scenario_cell", name=scenario.name, cell_hash=cell.cell_hash,
        overrides=cell.overrides, scenario=scenario.to_dict(),
        n_devices=scenario.n_devices, eta_max=ctx.eta_max, kappa=ctx.kappa,
        omega_var=ctx.weights.omega_var, omega_bias=ctx.weights.omega_bias,
        design=design, logs=logs, elapsed_s=time.perf_counter() - t0)


def _design_pack(ctx) -> tuple:
    """A cell's solved design parameters as picklable pure data.

    Parameter dataclasses hold only numpy arrays/scalars, so they cross
    the spawn boundary; workers replay the pack with ``set_design`` and
    never touch a design solver.
    """
    pack = []
    for prefix, family in (("ota", "ota"), ("dig", "digital")):
        for variant, suffix in (("designed", ""), ("direct", "_direct")):
            params = getattr(ctx, f"{prefix}_params{suffix}")
            if params is not None:
                pack.append((family, variant, params,
                             getattr(ctx, f"{prefix}_objective{suffix}")))
    return tuple(pack)


#: process-global memo so one worker builds each dataset/task/deployment
#: once across all the cells it is handed
_WORKER_MEMO = None


def _chaos_hook(cell_hash: str) -> None:
    """Test-only fault injection for the supervisor (env-gated, inert
    otherwise; spawn workers inherit the parent environment). The names
    are the port's own, so the reference's chaos tests never reach a port
    worker.

    ``REPRO_TORCH_CHAOS_KILL_DIR=<dir>`` — SIGKILL exactly one worker,
    once per directory (atomic ``O_CREAT|O_EXCL`` marker), simulating an
    OOM kill. ``REPRO_TORCH_CHAOS_HANG_HASH=<prefix>`` — cells whose hash
    matches the prefix hang, exercising the per-cell timeout path.
    """
    kill_dir = os.environ.get("REPRO_TORCH_CHAOS_KILL_DIR")
    if kill_dir:
        try:
            fd = os.open(os.path.join(kill_dir, "killed"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            pass
        else:
            os.close(fd)
            os.kill(os.getpid(), signal.SIGKILL)
    hang = os.environ.get("REPRO_TORCH_CHAOS_HANG_HASH")
    if hang and cell_hash.startswith(hang):
        time.sleep(3600)


def _worker_run_cell(job):
    """Pool worker: re-materialize one cell from pure data and run it on
    the job's device."""
    (scenario_dict, index, overrides, cell_hash, design_pack, memo_seed,
     cells_dir, device) = job
    _chaos_hook(cell_hash)
    global _WORKER_MEMO
    if _WORKER_MEMO is None:
        _WORKER_MEMO = mat.new_memo()
    # seed the sweep-level kappa estimates so workers never re-run the
    # w*-GD estimation the main process (or a sibling) already did
    _WORKER_MEMO._store.update(memo_seed)
    scenario = ScenarioSpec.from_dict(scenario_dict)
    ctx = mat.materialize(scenario, _WORKER_MEMO, device=device)
    for family, variant, params, objective in design_pack:
        ctx.set_design(family, variant, params, objective)
    cell = Cell(index=index, overrides=overrides, scenario=scenario,
                cell_hash=cell_hash)
    payload = _run_cell(cell, ctx)
    if cells_dir is not None:
        d = Path(cells_dir)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{cell_hash}.json").write_text(dump_json(payload))
    return index, payload


def _pool_worker(wid: int, jobq, resq) -> None:
    """Persistent parallel-sweep worker: drain jobs until the sentinel.

    Announces ``("start", wid, index)`` *before* running a cell so the
    supervisor's per-cell timeout clock starts at actual work start —
    process spawn and the first torch import are never billed to a cell.
    """
    while True:
        job = jobq.get()
        if job is None:
            return
        index = job[1]
        resq.put(("start", wid, index))
        try:
            _, payload = _worker_run_cell(job)
        except BaseException:              # noqa: BLE001 — shipped to parent
            resq.put(("error", wid, index, traceback.format_exc()))
        else:
            resq.put(("ok", wid, index, payload))


def _run_parallel(pl: Plan, todo, contexts, memo, cells_dir: Path,
                  save: bool, jobs: int, say, results, device,
                  cell_timeout_s: Optional[float] = None,
                  retries: int = 2) -> None:
    """Dispatch non-cached cells to supervised persistent spawn workers,
    designs solved inline in the main process.

    Spawn (not fork): the parent has initialized CUDA (the design
    solves), and forking a process with a live CUDA context is undefined
    behavior. On a card the parent builds every kernel before spawning,
    so no worker compiles inside its cell's timeout.

    Degradation ladder per cell (supervisor loop):

    * worker raises a Python exception — deterministic, never retried;
      collected (not fail-fast) and re-raised after the sweep drains, so
      completed cells persist their ``cells/<hash>.json`` and a re-run
      resumes from them;
    * worker process dies mid-cell — the cell is requeued on a fresh
      worker with exponential backoff (0.25 * 2^attempt s), up to
      ``retries`` extra attempts; exhausted crashes raise;
    * cell exceeds ``cell_timeout_s`` (measured from the worker's
      "start" message) — the worker is terminated and the cell retried
      the same way; exhausted timeouts finalize as ``status="timeout"``
      with an empty payload instead of raising (the sweep's other cells
      stay usable).

    A late result that arrives after its cell was requeued is accepted
    if the cell is not yet finalized and ignored as a duplicate if it is.
    """
    import multiprocessing as mp
    import queue as queue_mod

    todo_idx = {c.index for c in todo}
    memo_seed = {k: v for k, v in memo._store.items()
                 if isinstance(k, tuple) and k and k[0] == "kappa"}
    cell_by_index = {c.index: c for c in todo}

    # walk the dependency-ordered schedule: every design group solves (one
    # batched call) before its first dependent cell's job is enqueued
    queue_jobs = []
    for kind, item in pl.schedule():
        if kind == "design":
            live = [i for i in item.cell_indices if i in todo_idx]
            if not live:
                continue
            say(f"design {item.family} (N={item.n_devices}): "
                f"{len(live)} point(s), "
                + ("one batched solve" if item.batched else item.solver))
            _solve_group(_filtered(item, live), contexts, device)
        elif item.index in todo_idx:
            cell = item
            job = (cell.scenario.to_dict(), cell.index, cell.overrides,
                   cell.cell_hash, _design_pack(contexts[cell.index]),
                   memo_seed, str(cells_dir) if save else None,
                   str(device))
            say(f"cell {cell.index} [{cell.cell_hash}] -> worker "
                f"({len(schemes.expand_schemes(cell.scenario.schemes))} "
                "schemes)")
            queue_jobs.append(job)

    total = len(queue_jobs)
    if device.type == "cuda":
        from ..kernels import build
        build.build()
    ctx_mp = mp.get_context("spawn")
    resq = ctx_mp.Queue()
    n_workers = min(jobs, total)

    def _spawn_worker(wid):
        jobq = ctx_mp.Queue()
        proc = ctx_mp.Process(target=_pool_worker, args=(wid, jobq, resq),
                              daemon=True)
        proc.start()
        return {"proc": proc, "jobq": jobq, "index": None, "job": None,
                "started": None}

    ready = list(queue_jobs)       # FIFO of jobs awaiting a worker
    delayed = []                   # [(not_before, job)] backoff requeues
    attempts = {job[1]: 0 for job in queue_jobs}
    finalized: set[int] = set()
    errors = []
    workers = {wid: _spawn_worker(wid) for wid in range(n_workers)}
    next_wid = n_workers

    def _finish_ok(index, payload):
        cell = cell_by_index[index]
        results[index] = CellResult(
            index=index, cell_hash=cell.cell_hash,
            overrides=cell.overrides, status="computed",
            path=cells_dir / f"{cell.cell_hash}.json" if save else None,
            payload=payload)
        finalized.add(index)
        say(f"cell {cell.index} [{cell.cell_hash}] done")

    try:
        while len(finalized) < total:
            now = time.monotonic()
            ready.extend(j for t, j in delayed if t <= now)
            delayed = [(t, j) for t, j in delayed if t > now]

            # hand ready jobs to idle live workers (skip jobs finalized by
            # a late result that landed while they waited in the queue)
            for w in workers.values():
                while ready and ready[0][1] in finalized:
                    ready.pop(0)
                if not ready:
                    break
                if w["index"] is None and w["proc"].is_alive():
                    job = ready.pop(0)
                    w["index"], w["job"], w["started"] = job[1], job, None
                    w["jobq"].put(job)

            try:
                msg = resq.get(timeout=0.1)
            except queue_mod.Empty:
                msg = None
            if msg is not None:
                tag, wid, index = msg[0], msg[1], msg[2]
                w = workers.get(wid)
                if tag == "start":
                    if w is not None and w["index"] == index:
                        w["started"] = time.monotonic()
                else:
                    if index not in finalized:
                        if tag == "ok":
                            _finish_ok(index, msg[3])
                        else:   # deterministic Python error: never retried
                            errors.append((cell_by_index[index], msg[3]))
                            finalized.add(index)
                    if w is not None and w["index"] == index:
                        w["index"] = w["job"] = w["started"] = None
                continue        # drain results before liveness checks

            # liveness + per-cell deadline sweep
            now = time.monotonic()
            for wid in list(workers):
                w = workers[wid]
                alive = w["proc"].is_alive()
                timed_out = (alive and cell_timeout_s is not None
                             and w["started"] is not None
                             and now - w["started"] > cell_timeout_s)
                if alive and not timed_out:
                    continue
                index, job = w["index"], w["job"]
                if timed_out:
                    w["proc"].kill()
                w["proc"].join(timeout=5)
                del workers[wid]
                if index is not None and index not in finalized:
                    cell = cell_by_index[index]
                    attempts[index] += 1
                    why = ("timed out" if timed_out
                           else "lost its worker")
                    if attempts[index] > retries:
                        if timed_out:
                            say(f"cell {cell.index} [{cell.cell_hash}] "
                                f"{why}; retries exhausted -> "
                                'status="timeout"')
                            results[index] = CellResult(
                                index=index, cell_hash=cell.cell_hash,
                                overrides=cell.overrides, status="timeout",
                                path=None, payload={})
                            finalized.add(index)
                        else:
                            errors.append((
                                cell,
                                f"cell {why} {attempts[index]} time(s) "
                                "with no result"))
                            finalized.add(index)
                    else:
                        backoff = 0.25 * 2.0 ** (attempts[index] - 1)
                        say(f"cell {cell.index} [{cell.cell_hash}] {why}; "
                            f"retry {attempts[index]}/{retries} in "
                            f"{backoff:.2f}s")
                        delayed.append((now + backoff, job))
                if len(finalized) < total and len(workers) < n_workers:
                    workers[next_wid] = _spawn_worker(next_wid)
                    next_wid += 1
    finally:
        for w in workers.values():
            if w["proc"].is_alive():
                w["jobq"].put(None)
        for w in workers.values():
            w["proc"].join(timeout=5)
            if w["proc"].is_alive():
                w["proc"].kill()
                w["proc"].join(timeout=5)

    if errors:
        cell, detail = errors[0]
        raise RuntimeError(
            f"{len(errors)} of {total} sweep cell(s) failed in "
            f"workers (first: cell {cell.index} [{cell.cell_hash}]); "
            "completed cells are cached — re-run to resume"
        ) from RuntimeError(str(detail))


def execute(spec_or_plan, *, out_dir: Optional[Path] = None,
            force: bool = False, save: bool = True, jobs: int = 1,
            cell_timeout_s: Optional[float] = None, retries: int = 2,
            progress: Optional[Callable[[str], None]] = None,
            device=None) -> ResultSet:
    """Execute a scenario/sweep/plan into a ``ResultSet``.

    ``force=True`` ignores (and overwrites) cached cells; ``save=False``
    keeps the result in memory only (used by tests); ``jobs=K`` (K > 1)
    runs non-cached cells on a supervised K-worker process pool — same
    manifest, same per-cell artifacts, same resume semantics as serial.
    ``cell_timeout_s`` bounds one cell's compute time on the pool (the
    clock starts when a worker picks the cell up; exhausted cells finalize
    as ``status="timeout"``); ``retries`` is the number of *extra*
    attempts a timed-out or worker-crashed cell gets before finalizing.
    Both apply to the parallel path only — serial execution runs in-process
    and cannot be preempted. ``device`` (default: the card, raising
    without one; ``"cpu"`` for the plain path) runs the kappa estimates,
    the batched design solves and every trainer.
    """
    say = progress if progress is not None else (lambda msg: None)
    dev = resolve_device(device)
    pl = (spec_or_plan if isinstance(spec_or_plan, Plan)
          else make_plan(spec_or_plan))
    _check_supported(pl)
    if jobs < 1:
        raise ValueError(f"jobs must be >= 1, got {jobs}")
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if cell_timeout_s is not None and cell_timeout_s <= 0:
        raise ValueError(
            f"cell_timeout_s must be positive, got {cell_timeout_s}")
    out_dir = Path(out_dir) if out_dir is not None else \
        default_out_dir(pl.name)
    cells_dir = out_dir / "cells"
    t0 = time.perf_counter()

    results: dict[int, CellResult] = {}
    todo = []
    for cell in pl.cells:
        cached = None if force else _load_cached(
            cells_dir / f"{cell.cell_hash}.json")
        if cached is not None:
            say(f"cell {cell.index} [{cell.cell_hash}] cached")
            results[cell.index] = CellResult(
                index=cell.index, cell_hash=cell.cell_hash,
                overrides=cell.overrides, status="cached",
                path=cells_dir / f"{cell.cell_hash}.json", payload=cached)
        else:
            todo.append(cell)

    # materialize every non-cached cell (memoized across the sweep), then
    # walk the dependency-ordered schedule: each design group's grid
    # solves in one batched call right before its first dependent cell
    memo = mat.new_memo()
    contexts = {c.index: mat.materialize(c.scenario, memo, device=dev)
                for c in todo}
    todo_idx = set(contexts)
    if jobs > 1 and todo:
        _run_parallel(pl, todo, contexts, memo, cells_dir, save, jobs,
                      say, results, dev, cell_timeout_s=cell_timeout_s,
                      retries=retries)
    else:
        for kind, item in pl.schedule():
            if kind == "design":
                live = [i for i in item.cell_indices if i in todo_idx]
                if not live:
                    continue
                say(f"design {item.family} (N={item.n_devices}): "
                    f"{len(live)} point(s), "
                    + ("one batched solve" if item.batched else item.solver))
                _solve_group(_filtered(item, live), contexts, dev)
                continue
            cell = item
            if cell.index not in todo_idx:
                continue
            say(f"cell {cell.index} [{cell.cell_hash}] running "
                f"{len(schemes.expand_schemes(cell.scenario.schemes))} "
                "schemes")
            payload = _run_cell(cell, contexts[cell.index])
            path = None
            if save:
                # persist each cell the moment it completes so an
                # interrupted sweep resumes from the finished cells, not
                # from scratch
                path = cells_dir / f"{cell.cell_hash}.json"
                cells_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(dump_json(payload))
            results[cell.index] = CellResult(
                index=cell.index, cell_hash=cell.cell_hash,
                overrides=cell.overrides, status="computed",
                path=path, payload=payload)

    ordered = [results[c.index] for c in pl.cells]
    manifest = result_payload(
        "result_set", name=pl.name, spec=pl.sweep.to_dict(),
        sweep_hash=pl.sweep.spec_hash(), git_rev=git_rev(),
        n_cells=len(ordered),
        axes={p: list(v) for p, v in pl.sweep.axes},
        cells=[{"index": c.index, "cell_hash": c.cell_hash,
                "overrides": c.overrides, "status": c.status,
                "elapsed_s": c.payload.get("elapsed_s")}
               for c in ordered],
        elapsed_s=time.perf_counter() - t0)
    rs = ResultSet(manifest=manifest, cells=ordered)
    if save:
        rs.save(out_dir)
        say(f"manifest -> {out_dir / 'manifest.json'}")
    return rs


def _filtered(group, live):
    """A design group restricted to its non-cached member cells."""
    return dataclasses.replace(
        group, cell_indices=tuple(live),
        needs_direct=tuple(i for i in group.needs_direct if i in live))
