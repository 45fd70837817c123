"""Ranks and process groups for the port's multi-card paths.

The reference is single-controller: one JAX process drives every device
through ``shard_map``. The port runs one process a rank under
``torch.distributed`` instead, and this module starts them:

  * :func:`init_from_env` joins the group ``torchrun`` set up (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):

        torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch ...

  * :func:`spawn` starts ``world`` processes itself, rendezvous through a
    ``FileStore`` under ``store_dir`` (no port, so parallel test workers
    never collide), runs ``fn(rank, *args)`` in each and returns every
    rank's result, in rank order. Its ranks fork from a fork server (the
    ``forkserver`` start method): a fresh interpreter that has imported
    :data:`PRELOAD` and never touches a card, so a rank starts with no
    CUDA state, as a ``spawn``-started one would, but without importing
    torch again. :func:`prestart` starts that server ahead of time.

Rules, the same for both:

  * a rank works on ``cuda:(local_rank % device_count)``, or on the CPU
    when the caller asks for it (then on one intra-op thread, so W ranks
    do not oversubscribe the host's cores);
  * the backend is ``nccl`` when every rank has a card of its own and
    ``gloo`` when ranks share a card or run on the CPU (:func:`backend_for`,
    printed by each rank as it joins);
  * the CUDA kernels are built once in the parent before any rank starts
    (``kernels.build.build``); ranks only load them.

Under ``gloo`` a collective on a CUDA tensor goes through the host
(``core/dist.py``, which holds the collectives and the client mesh the
FL layers use).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
import traceback
import uuid
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

#: seconds a spawned group may take before its ranks are killed
SPAWN_TIMEOUT_S = 600.0

#: modules the fork server imports before a rank forks from it: torch,
#: ``torch._dynamo`` (which ``torch.utils.checkpoint``, the train steps'
#: remat, imports at its first call) and this module
PRELOAD = ("torch", "torch._dynamo", __name__)


@dataclasses.dataclass(frozen=True)
class Rank:
    """This process's place in the group."""
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str


def backend_for(device_type: str, world: int, n_cards: int) -> str:
    """``nccl`` when each of ``world`` ranks has its own card, else
    ``gloo`` (ranks on the CPU, or sharing cards: NCCL refuses two ranks
    on one device)."""
    if device_type == "cuda" and n_cards >= world:
        return "nccl"
    return "gloo"


def _join(rank: int, world: int, local_rank: int, device_type: str, *,
          store=None, timeout_s: float = SPAWN_TIMEOUT_S) -> Rank:
    if device_type == "cpu":
        torch.set_num_threads(1)
        device, n_cards = torch.device("cpu"), 0
    elif device_type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("a CUDA rank needs a card and none is "
                               "visible; pass device='cpu'")
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    backend = backend_for(device_type, world, n_cards)
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    print(json.dumps({"rank": rank, "world": world, "backend": backend,
                      "device": str(device), "cards": n_cards}), flush=True)
    return Rank(rank, world, local_rank, device, backend)


def init_from_env(device=None) -> Rank:
    """Join the process group ``torchrun`` describes in the environment;
    ``device`` "cuda" (the default) or "cpu"."""
    device_type = torch.device("cuda" if device is None else device).type
    return _join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                 int(os.environ.get("LOCAL_RANK", os.environ["RANK"])),
                 device_type)


def leave() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------------ spawn

def _context():
    import multiprocessing as mp
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", *PRELOAD])
    return ctx


def prestart() -> None:
    """Start the fork server :func:`spawn`'s ranks fork from, if it is not
    running, so that its imports run now, beside the caller's own work.
    A rank inherits the environment, working directory and preloaded
    modules the server started with; ``sys.path`` and the arguments come
    from the caller at each :func:`spawn`."""
    from multiprocessing import forkserver
    _context()
    forkserver.ensure_running()


def _rank_main(rank: int, world: int, device_type: str, store_path: str,
               out_dir: str, timeout_s: float, fn: Callable, args: tuple):
    out = Path(out_dir)
    try:
        store = dist.FileStore(store_path, world)
        _join(rank, world, rank, device_type, store=store,
              timeout_s=timeout_s)
        result = fn(rank, *args)
        dist.barrier()
        leave()
        torch.save(result, out / f"result_{rank}.pt")
    except BaseException:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, *, device="cuda", store_dir,
          args: tuple = (), timeout_s: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in one
    group and return their results (picklable; tensors are saved and
    loaded with ``torch.save``) in rank order.

    ``fn`` must be importable by name (a module-level function). The
    caller's main module is imported in the fork server (as the ``spawn``
    start method imports it in each process), so its top level must not
    depend on ``sys.argv``. CUDA ranks take cards as
    :func:`init_from_env`'s do; the kernels are built here first. If a rank raises or dies, or the group outlives
    ``timeout_s``, every rank still running is killed, and the traceback
    of the rank that failed first is raised here as a RuntimeError.
    """
    device_type = torch.device(device).type
    if device_type == "cuda":
        from ..kernels import build
        build.build()
    run_dir = Path(store_dir) / f"spawn-{uuid.uuid4().hex[:12]}"
    run_dir.mkdir(parents=True)
    ctx = _context()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, device_type,
                               str(run_dir / "store"), str(run_dir),
                               timeout_s, fn, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(not p.is_alive() and p.exitcode != 0 for p in procs):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"spawn: {world} ranks did not finish in {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        # the rank that failed first wrote its traceback first; a rank
        # killed here, or dead without one, comes last
        def when(r):
            err = run_dir / f"error_{r}.txt"
            return err.stat().st_mtime if err.exists() else float("inf")
        first = min(failed, key=when)
        err = run_dir / f"error_{first}.txt"
        tb = (err.read_text() if err.exists()
              else f"(no traceback: exit code {procs[first].exitcode})")
        raise RuntimeError(f"rank {first} of {world} failed:\n{tb}")
    return [torch.load(run_dir / f"result_{r}.pt", weights_only=False)
            for r in range(world)]
