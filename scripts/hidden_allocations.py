#!/usr/bin/env python3
"""Device memory that CUDA ops allocate and free inside themselves, which
no dispatch mode sees, on one loss and backward of tinyllama-1.1b.

    python3 scripts/hidden_allocations.py [--seq 2048] [--out hidden.json]

Needs the card. The pass (1 x ``--seq`` tokens, random bf16 weights from
seed 0, with and without layer-group remat) runs once after a warm-up
under ``repro_torch.launch.analysis.LiveBytes`` on the card, beside
``torch.cuda.max_memory_allocated``; then once more under a dispatch mode
that reads the caching allocator around every op: the peak inside the op
less what the op leaves allocated is what it allocated and freed inside
itself. Prints one JSON line a pass: the card's peak, the tracker's (with
``cuda_workspace`` and without), and the ops whose hidden bytes reach 1
MiB, grouped by op and operand layout, largest total first.
"""
import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def hidden_ops(step):
    """{op and operand layouts: [calls, largest, total hidden bytes]}."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Hidden(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            peak = torch.cuda.max_memory_allocated() - before
            hidden = peak - max(torch.cuda.memory_allocated() - before, 0)
            if hidden >= 1 << 20:
                key = str((str(func), [(tuple(a.shape), str(a.dtype),
                                        a.is_contiguous())
                                       for a in args if torch.is_tensor(a)]))
                row = self.rows.setdefault(key, [0, 0, 0])
                row[0] += 1
                row[1] = max(row[1], hidden)
                row[2] += hidden
            return out

    mode = Hidden()
    with mode:
        step()
    torch.cuda.synchronize()
    return dict(sorted(mode.rows.items(), key=lambda kv: -kv[1][2]))


def one_pass(model, batch, remat):
    import torch
    from repro_torch.launch import analysis
    from repro_torch.models import loss_fn

    def step():
        model.forward = functools.partial(type(model).forward, model,
                                          remat=remat)
        try:
            loss, _ = loss_fn(model, batch)
            loss.backward()
        finally:
            del model.forward
        return loss.detach()

    step()                                    # warm: library workspaces
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}
    for workspaces in (True, False):
        torch.cuda.reset_peak_memory_stats()
        # device None: storages on every device, no workspace rule
        live = analysis.LiveBytes((list(model.parameters()), batch),
                                  device="cuda" if workspaces else None)
        with live:
            step()
        torch.cuda.synchronize()
        peaks["card" if workspaces else "card_again"] = \
            torch.cuda.max_memory_allocated()
        peaks["tracked" if workspaces else "tracked_no_workspace"] = \
            live.peak
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    rows = hidden_ops(step)
    model.zero_grad(set_to_none=True)
    return {"remat": remat, "base_bytes": base, **{f"{k}_bytes": v
                                                   for k, v in peaks.items()},
            "hidden": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("hidden_allocations: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import make_batch, make_model
    cfg = get_config(args.arch)
    model = make_model(cfg, seed=0)
    batch = make_batch(cfg, 1, args.seq,
                       torch.Generator(device="cuda").manual_seed(13))
    lines = [one_pass(model, batch, remat) for remat in (False, True)]
    for line in lines:
        print(json.dumps({"arch": args.arch, "seq": args.seq, **line}),
              flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
