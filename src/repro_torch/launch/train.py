"""FL LM training launcher (counterpart of ``repro.launch.train``).

Runs the whole pipeline: the offline OTA design from the channel
statistics (``design_ota_direct``) -> per-round fading and participation
thresholds -> the FL train step with the wireless collective -> checkpoints.
On one card the clients are ``--n-clients`` (default 4), run one after
another; under ``torchrun`` they are the ranks, one client a rank, as the
reference's are its devices (``data_axis=len(jax.devices())``): every
rank draws the same global batch and keeps its client's rows, and rank 0
logs and writes the checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch tinyllama-1.1b --aggregator digital --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --no-reduced --steps 3        # on the card
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --arch tinyllama-1.1b --steps 3        # 2 ranks
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --arch qwen3-moe-30b-a3b --moe-impl ep --steps 3

``--moe-impl ep`` (under ``torchrun``) trains a MoE model expert-parallel:
each rank builds only its block of the expert leaves
(``launch.sharding.Placement``) and the MoE blocks exchange tokens over
the ranks; its checkpoints would hold one rank's experts, so it takes no
``--ckpt-dir``.

``--arch`` takes the reduced (``scaled_down()``, f32) variant unless
``--no-reduced``; without ``--arch`` a small llama-style model of
``--layers`` x ``--d-model`` in f32. Weights are random, from ``--seed``.
The launcher feeds tokens only, as the reference's does, so it refuses
the audio and VLM archs (whisper-tiny, internvl2-2b); they train through
``steps.make_train_step`` with frames or patches in the batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import kernels
from ..checkpoint import save_checkpoint
from ..configs import ARCH_IDS, get_config
from ..core import rngstream
from ..core.bounds import ObjectiveWeights
from ..core.channel import FadingProcess, WirelessConfig, make_deployment
from ..core.ota_design import OTADesignSpec, design_ota_direct
from ..models import make_model, param_count
from ..models.common import ModelConfig
from ..optim.sgd import SGDConfig
from . import distributed
from .mesh import client_index, make_host_mesh, n_clients as mesh_clients
from .sharding import Placement
from .steps import fl_round_arrays, make_train_step


def synthetic_token_batch(rng: np.random.Generator, vocab: int, batch: int,
                          seq: int) -> dict:
    """Markov token stream with learnable bigram structure (the
    reference's draws, as int64 tensors on the CPU)."""
    succ = (np.arange(vocab) * 7 + 3) % vocab
    toks = np.empty((batch, seq), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    for t in range(1, seq):
        follow = rng.random(batch) < 0.8
        toks[:, t] = np.where(follow, succ[toks[:, t - 1]],
                              rng.integers(0, vocab, batch))
    return {"tokens": torch.from_numpy(toks).long()}


def build_cfg(args) -> ModelConfig:
    if args.arch:
        cfg = get_config(args.arch)
        return cfg.scaled_down() if args.reduced else cfg
    return ModelConfig(name="fl-lm", arch_type="dense",
                       n_layers=args.layers, d_model=args.d_model,
                       n_heads=8, n_kv_heads=4, d_ff=3 * args.d_model,
                       vocab_size=args.vocab, dtype=torch.float32)


def design(n_clients: int, *, eta: float, g_max: float):
    """The deployment (seed 1) and its ``design_ota_direct`` parameters at
    the launcher's spec (d = 100,000, non-convex weights)."""
    dep = make_deployment(WirelessConfig(n_devices=n_clients, seed=1))
    w = ObjectiveWeights.non_convex(eta=eta, smooth_l=10.0,
                                    kappa_nc=0.5 * g_max, n=n_clients)
    spec = OTADesignSpec(lambdas=dep.lambdas, dim=100_000, g_max=g_max,
                         e_s=dep.cfg.energy_per_symbol,
                         n0=dep.cfg.noise_power, weights=w)
    return dep, design_ota_direct(spec)[0]


@dataclasses.dataclass
class TrainLog:
    losses: list          # mean unweighted loss per step
    step_s: list          # host seconds per step, ending in a synchronise
    launches: list        # the port's kernel launches per step


def train(model, *, aggregator: str = "ota", steps: int = 100,
          batch: int = 8, seq: int = 128, n_clients: int = 4,
          mesh=None, eta: float = 1.0, momentum: float = 0.0,
          g_max: float = 10.0, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          flags: Optional[dict] = None,
          log: Callable[[str], None] = print) -> TrainLog:
    """Train ``model`` for ``steps`` FL rounds on Markov token batches from
    ``np.random.default_rng(seed)``, as the reference launcher does: OTA
    participation chi_m = 1{|h_m|^2 >= tau_m} from the fading process
    (seed 7), weights gamma_m / mean(gamma), alpha / mean(gamma), noise
    scale 1e-2 sqrt(N0)/alpha, 255 quantizer levels, key t at step t.
    The batches are tokens only, as the reference's, so an audio or VLM
    model raises ValueError. With a ``mesh`` the clients are its ranks
    (``n_clients`` is ignored), and only client 0 logs and checkpoints;
    ``flags`` go to the train step (``{"moe_impl": "ep"}``: expert
    parallel, no checkpoints)."""
    cfg = model.cfg
    if cfg.arch_type in ("audio", "vlm"):
        raise ValueError(
            f"{cfg.name}: the launcher feeds tokens only, and an "
            f"{cfg.arch_type} model also needs "
            f"{'frames' if cfg.arch_type == 'audio' else 'patches'}; "
            f"train it through launch.steps.make_train_step with them in "
            f"the batch")
    if ckpt_dir and model.placement is not None:
        raise ValueError("a model holding its rank's blocks would "
                         "checkpoint one rank's experts: no --ckpt-dir "
                         "with --moe-impl ep")
    dev = model.device
    lead = mesh is None or client_index(mesh) == 0
    if mesh is not None:
        n_clients = mesh_clients(mesh)
    if not lead:
        log = _quiet
    dep, ota_params = design(n_clients, eta=eta, g_max=g_max)
    log(f"{'mesh=' + str(mesh.shape) + ' ' if mesh is not None else ''}"
        f"clients={n_clients} p_m="
        f"{np.round(ota_params.participation_levels(dep.lambdas), 3)}")
    step = make_train_step(model, n_clients=n_clients, mesh=mesh,
                           aggregator=aggregator,
                           sgd=SGDConfig(eta=eta, momentum=momentum),
                           batch=batch, seq=seq, flags=flags)
    fading = FadingProcess(dep, seed=7)
    taus = ota_params.thresholds()
    rng = np.random.default_rng(seed)
    gam_scale = float(np.mean(ota_params.gammas))
    out = TrainLog([], [], [])
    t0 = time.perf_counter()
    for t in range(steps):
        batch_in = {k: v.to(dev) for k, v in synthetic_token_batch(
            rng, model.cfg.vocab_size, batch, seq).items()}
        chis = (fading.gains(t) >= taus).astype(np.float64)
        fl = fl_round_arrays(
            n_clients if mesh is None else mesh,
            gammas=ota_params.gammas / gam_scale, chis=chis,
            alpha=ota_params.alpha / gam_scale,
            noise_scale=np.sqrt(ota_params.noise_psd) / ota_params.alpha
            * 1e-2, levels=255.0)
        c0 = kernels.launch_counts()
        ts = time.perf_counter()
        loss = float(step(batch_in, fl, rngstream.prng_key(t)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.step_s.append(time.perf_counter() - ts)
        out.losses.append(loss)
        c1 = kernels.launch_counts()
        out.launches.append({k: c1[k] - c0[k] for k in c0})
        if t % 10 == 0 or t == steps - 1:
            log(f"step {t:4d}  loss {loss:.4f}  "
                f"({time.perf_counter() - t0:.1f}s)")
        if ckpt_dir and (t + 1) % ckpt_every == 0 and lead:
            log(f"checkpoint -> {save_checkpoint(ckpt_dir, t + 1, model)}")
    return out


def _quiet(_: str) -> None:
    pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--aggregator", default="ota",
                    choices=("ideal", "ota", "digital"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-clients", type=int, default=None,
                    help="clients on one card (default 4); under torchrun "
                         "the clients are the ranks")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--momentum", type=float, default=0.0,
                    help="inert, as in the reference: each train step "
                         "starts SGD from zero momentum, so any value "
                         "trains as 0")
    ap.add_argument("--g-max", type=float, default=10.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--moe-impl", default="auto", choices=("auto", "ep"),
                    help="ep: expert-parallel MoE over the ranks (under "
                         "torchrun)")
    args = ap.parse_args(argv)

    mesh, say = None, print
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = distributed.init_from_env(args.device)
        if args.n_clients not in (None, rank.world):
            raise SystemExit(f"--n-clients {args.n_clients}: under torchrun "
                             f"the clients are the {rank.world} ranks")
        mesh = make_host_mesh(device_type=rank.device.type)
        say = print if rank.rank == 0 else _quiet
    ep = args.moe_impl == "ep"
    if ep and mesh is None:
        raise SystemExit("--moe-impl ep runs over ranks: start it under "
                         "torchrun")
    cfg = build_cfg(args)
    model = make_model(cfg, seed=args.seed, device=args.device,
                       placement=Placement(mesh) if ep else None)
    say(f"model: {cfg.name}  params={param_count(model):,}  "
        f"on {model.device}")
    train(model, aggregator=args.aggregator, steps=args.steps,
          batch=args.batch, seq=args.seq,
          n_clients=args.n_clients or 4, mesh=mesh, eta=args.eta,
          momentum=args.momentum, g_max=args.g_max, seed=args.seed,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          flags={"moe_impl": "ep"} if ep else None, log=say)
    say("done.")
    distributed.leave()


if __name__ == "__main__":
    main()
