"""Serve a model with batched requests: prefill, then token-by-token decode
with temperature sampling (counterpart of ``examples/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --tokens 32

The CLI serves the reference's ``scaled_down()`` sizes of ``--arch``
(falcon-mamba-7b by default; any registered arch: recurrentgemma-2b, the
dense models, the MoE models qwen3-moe-30b-a3b and kimi-k2-1t-a32b,
whisper-tiny fed random frame embeddings and internvl2-2b fed random
patch embeddings) with random weights, the Mamba scan and the RG-LRU
recurrence on their hand-written kernels (``mamba_kernel``,
``rglru_kernel``), on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --device cpu

:func:`serve` is the request loop for any model already built, at any
width; its ``flags`` choose the attention route (``{"attn_impl":
"chunked"}`` for prompts whose (S, T) scores would not fit). With a
``mesh`` (``launch.mesh.make_host_mesh``) each rank serves its B/N rows
of the batch, and a MoE model built with ``launch.sharding.Placement``
holds its share of the experts and runs the expert-parallel route; under
``torchrun`` the CLI does so over the ranks:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import torch

from .. import kernels
from ..configs import ARCH_IDS, get_config
from ..models import effective_seq, make_batch, make_model
from . import distributed
from .mesh import make_host_mesh
from .sharding import Placement
from .steps import make_decode_step, make_prefill_step, serve_rows

#: the serve path's flags: the Mamba scan and the RG-LRU recurrence go to
#: their CUDA kernels
SERVE_FLAGS = {"mamba_kernel": True, "rglru_kernel": True}


@dataclasses.dataclass
class ServeResult:
    """One run; on a mesh every tensor is this rank's rows."""
    prompt: torch.Tensor              # (B, S) prompt tokens
    prefix: int                       # positions a request's prefill fills
    generated: torch.Tensor           # (B, T + 1): argmax, then T samples
    prefill_logits: torch.Tensor      # (B, V)
    decode_logits: Optional[torch.Tensor]   # (T, B, V) if kept
    prefill_s: float
    decode_s: float
    prefill_launches: dict            # kernel launches of the prefill
    decode_launches: dict             # ... and of all decode steps

    @property
    def prefill_tokens_per_s(self) -> float:
        """Prefilled positions (a VLM's patches included) a second."""
        return self.prompt.shape[0] * self.prefix / self.prefill_s

    @property
    def decode_tokens_per_s(self) -> float:
        batch, steps = self.generated.shape[0], self.generated.shape[1] - 1
        return batch * steps / self.decode_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model, *, batch: int = 4, prompt_len: int = 32, tokens: int = 32,
          temperature: float = 0.8, seed: int = 1,
          flags: Optional[dict] = None, feed: Optional[torch.Tensor] = None,
          keep_logits: bool = False, mesh=None) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (drawn
    from a CPU generator seeded with ``seed``, with ``make_batch``'s
    patches or frames), then decode ``tokens`` steps.
    The first decode input is the prefill's argmax; each later one is
    sampled at ``temperature`` from a generator seeded with ``seed + 1``
    — unless ``feed`` (B, tokens + 1), another run's ``generated``, gives
    them all. As ``examples/serve.py``: caches of ``prompt_len +
    vision_prefix + tokens + 1`` slots, the first decode at the text
    tokens plus the patch prefix. Times are host clock around work that
    ends in a synchronise. On a ``mesh`` every rank draws the same
    prompts and serves its rows of them (``steps.serve_rows``; ``feed``
    is still the whole batch's), sampling from its own generator."""
    cfg, dev = model.cfg, model.device
    flags = SERVE_FLAGS if flags is None else flags
    prompt_len = effective_seq(cfg, prompt_len)
    cache_len = prompt_len + cfg.vision_prefix + tokens + 1
    prefill = make_prefill_step(model, batch=batch, seq=prompt_len,
                                cache_len=cache_len, flags=flags, mesh=mesh)
    decode = make_decode_step(model, batch=batch, cache_len=cache_len,
                              flags=flags, mesh=mesh)
    rows = serve_rows(mesh, batch, {}) or slice(0, batch)
    if feed is not None:
        feed = feed[rows]
    # the prompts come from the CPU, so every device serves the same ones
    inputs = {k: v.to(dev) for k, v in make_batch(
        cfg, batch, prompt_len, torch.Generator().manual_seed(seed)).items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prefix = inputs["tokens"].shape[1] + cfg.vision_prefix
    local = rows.stop - rows.start

    _sync(dev)
    counts0 = kernels.launch_counts()
    t0 = time.perf_counter()
    logits, caches, memory = prefill(inputs)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    counts1 = kernels.launch_counts()
    prefill_logits = logits

    tok = (feed[:, :1] if feed is not None
           else torch.argmax(logits, -1)[:, None])
    generated, kept = [tok], []
    t0 = time.perf_counter()
    for i in range(tokens):
        pos = torch.full((local,), prefix + i, dtype=torch.int64,
                         device=dev)
        logits, caches = decode(tok, pos, caches, memory)
        if keep_logits:
            kept.append(logits)
        if feed is not None:
            tok = feed[:, i + 1:i + 2]
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        generated.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    counts2 = kernels.launch_counts()
    return ServeResult(
        prompt=inputs["tokens"][rows], prefix=prefix,
        generated=torch.cat(generated, dim=1),
        prefill_logits=prefill_logits,
        decode_logits=torch.stack(kept) if keep_logits else None,
        prefill_s=prefill_s, decode_s=decode_s,
        prefill_launches={k: counts1[k] - counts0[k] for k in counts0},
        decode_launches={k: counts2[k] - counts1[k] for k in counts0})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="falcon-mamba-7b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    mesh, placement, say = None, None, print
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = distributed.init_from_env(args.device)
        mesh = make_host_mesh(device_type=rank.device.type)
        placement = Placement(mesh)
        say = print if rank.rank == 0 else (lambda _: None)
    cfg = get_config(args.arch).scaled_down()
    model = make_model(cfg, seed=0, device=args.device, placement=placement)
    out = serve(model, batch=args.batch, prompt_len=args.prompt_len,
                tokens=args.tokens, temperature=args.temperature,
                mesh=mesh)
    say(f"[{args.arch}] prefill({args.batch}x{out.prompt.shape[1]}) "
        f"in {out.prefill_s:.2f}s on {model.device}"
        + (f", {mesh.shape}" if mesh is not None else ""))
    say(f"decoded {args.tokens} tokens x {out.generated.shape[0]} requests "
        f"in {out.decode_s:.2f}s ({out.decode_tokens_per_s:.1f} tok/s)")
    for b in range(out.generated.shape[0]):
        say(f"  request {b}: {out.generated[b][:16].tolist()} ...")
    distributed.leave()


if __name__ == "__main__":
    main()
