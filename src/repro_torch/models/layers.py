"""Model blocks (counterpart of ``repro.models.layers``): the Mamba-1 part.

Conventions as the reference's: x is (B, S, d); decode calls use S == 1
plus a cache; caches are dicts of tensors, ``{"conv": (B, K-1, d_inner)``
in the model dtype, ``"h": (B, d_inner, n)`` in f32``}``. ``flags`` holds
runtime options:

  * ``mamba_kernel`` — the scan goes to ``kernels.ops.selective_scan``
    (the hand-written CUDA kernel on the card); with ``use_kernel=False``
    there it runs the kernel's plain version, which gives the same bits;
  * ``mamba_fused`` (default True) — the chunked scan with the
    C-projection fused into the chunk loop, in plain PyTorch;
  * neither — the materialised route through ``linear_scan_chunked``;
  * ``scan_chunk`` — the chunk of both plain routes (default 128).

Attention, MLP, MoE and RG-LRU blocks are not ported yet (ROADMAP Queue 1
item 10); their entry points raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops as kops
from .common import ModelConfig, ParamInit, ParamModule, silu, softplus

NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 item 10: the model zoo; "
              "only the Mamba-1 block runs in the port)")


def _not_ported(block: str):
    def fn(*args, **kw):
        raise NotImplementedError(f"{block} {NOT_PORTED}")
    fn.__name__ = block
    return fn


init_attention = attention_apply = _not_ported("attention")
init_mlp = mlp_apply = _not_ported("the MLP block")
init_moe = moe_apply = _not_ported("the MoE block")
init_rglru = rglru_apply = _not_ported("the RG-LRU block")


# ================================================= chunked linear scans

def _scan_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 from h = 0,
    as (A_cum, B_cum) with h_t = A_cum_t h_{-1} + B_cum_t: log2(c) steps
    of combine(l, r) = (a_l a_r, b_l a_r + b_r) (Hillis-Steele)."""
    c = a.shape[1]
    off = 1
    while off < c:
        a_new, b_new = a.clone(), b.clone()
        b_new[:, off:] = b[:, :-off] * a[:, off:] + b[:, off:]
        a_new[:, off:] = a[:, :-off] * a[:, off:]
        a, b = a_new, b_new
        off *= 2
    return a, b


def _pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    if not pad:
        return t
    fill = t.new_full((t.shape[0], pad) + t.shape[2:], value)
    return torch.cat([t, fill], dim=1)


def linear_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int = 128):
    """h_t = a_t * h_{t-1} + b_t elementwise over axis 1 of (B, S, ...):
    a sequential loop over chunks with a log-step scan inside each, padding
    with a = 1, b = 0. Returns (h_all (B, S, ...), h_last (B, ...))."""
    S = a.shape[1]
    chunk = min(chunk, S)
    pad = -S % chunk
    a, b = _pad_seq(a, pad, 1.0), _pad_seq(b, pad)
    h, outs = h0, []
    for s0 in range(0, S + pad, chunk):
        A, Bv = _scan_chunk(a[:, s0:s0 + chunk], b[:, s0:s0 + chunk])
        h_all = A * h[:, None] + Bv
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1)[:, :S], h.clone()


# ============================================================ conv1d state

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq. x: (B, S, D), w: (K, D). Returns
    (y, state') where state' holds the last K-1 inputs for streaming
    decode. Sums as the reference: ((x_0 w_0 + x_1 w_1) + ...) + bias."""
    K = w.shape[0]
    B, S, D = x.shape
    if state is None:
        state = x.new_zeros(B, K - 1, D)
    xp = torch.cat([state, x], dim=1)              # (B, S+K-1, D)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    y = y + bias
    # a copy, so the cache does not hold on to the whole of xp
    new_state = xp[:, -(K - 1):].clone() if K > 1 else state
    return y, new_state


# ================================================================= Mamba-1

def init_mamba(init: ParamInit, p: ParamModule, cfg: ModelConfig) -> None:
    d, di, n, dr, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    p.param(init, "in_proj", (d, 2 * di))
    p.param(init, "conv_w", (K, di), scale=0.5)
    p.param(init, "conv_b", (di,), init="zeros")
    p.param(init, "x_proj", (di, dr + 2 * n))
    p.param(init, "dt_proj", (dr, di))
    p.param(init, "dt_bias", (di,), init="zeros")
    p.param(init, "a_log", (di, n), init="ssm_a")
    p.param(init, "d_skip", (di,), init="ones")
    p.param(init, "out_proj", (di, d))


def _selective_scan_fused(dt, Bmat, xb, A, Cmat, h0, chunk: int):
    """Chunked selective scan with the C-projection fused into the chunk
    loop: the loop carries h (B, di, n) and keeps only y (B, S, di); the
    (B, chunk, di, n) transition tensors live one chunk at a time."""
    S = dt.shape[1]
    chunk = min(chunk, S)
    pad = -S % chunk
    dt, Bmat, Cmat, xb = (_pad_seq(t, pad) for t in (dt, Bmat, Cmat, xb))
    h, ys = h0, []
    for s0 in range(0, S + pad, chunk):
        sl = slice(s0, s0 + chunk)
        dt_c = dt[:, sl, :, None]
        a_c = torch.exp(dt_c * A)                          # (B, c, di, n)
        b_c = (dt_c * Bmat[:, sl, None, :]) * xb[:, sl].float()[..., None]
        A_cum, B_cum = _scan_chunk(a_c, b_c)
        h_all = A_cum * h[:, None] + B_cum
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Cmat[:, sl]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h.clone()


def mamba_apply(cfg: ModelConfig, p, x: torch.Tensor,
                cache: Optional[dict] = None, mode: str = "train",
                flags: Optional[dict] = None):
    """Mamba-1 selective SSM (``repro.models.layers.mamba_apply``).
    Returns (out (B, S, d), {"conv": ..., "h": ...})."""
    flags = flags or {}
    S = x.shape[1]
    di, n, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    xz = x @ p["in_proj"]
    xb, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    xb, conv_state = causal_conv1d(xb, p["conv_w"], p["conv_b"], conv_state)
    xb = silu(xb)
    proj = xb @ p["x_proj"]
    dt_raw = proj[..., :dr]
    Bmat = proj[..., dr:dr + n].float()                       # (B, S, n)
    Cmat = proj[..., dr + n:].float()
    dt = softplus(dt_raw @ p["dt_proj"] + p["dt_bias"]).float()  # (B, S, di)
    A = -torch.exp(p["a_log"].float())                        # (di, n)
    h0 = (cache["h"] if cache is not None
          else x.new_zeros(x.shape[0], di, n, dtype=torch.float32))
    if mode == "decode" and S == 1:
        a_1 = torch.exp(dt[:, 0, :, None] * A)
        b_1 = (dt[:, 0, :, None] * Bmat[:, 0, None, :]
               * xb.float()[:, 0, :, None])
        h_last = a_1 * h0 + b_1
        y = torch.einsum("bdn,bn->bd", h_last, Cmat[:, 0])[:, None]
    elif flags.get("mamba_kernel", False):
        y, h_last = kops.selective_scan(
            dt, xb.float(), Bmat, Cmat, A, h0,
            use_kernel=flags.get("use_kernel", True))
    elif flags.get("mamba_fused", True):
        y, h_last = _selective_scan_fused(dt, Bmat, xb, A, Cmat, h0,
                                          chunk=flags.get("scan_chunk", 128))
    else:
        a_seq = torch.exp(dt[..., None] * A)                  # (B, S, di, n)
        b_seq = (dt[..., None] * Bmat[:, :, None, :]
                 * xb.float()[..., None])
        h_all, h_last = linear_scan_chunked(
            a_seq, b_seq, h0, chunk=flags.get("scan_chunk", 128))
        y = torch.einsum("bsdn,bsn->bsd", h_all, Cmat)
    y = y.to(x.dtype) + p["d_skip"] * xb
    y = y * silu(z)
    out = y @ p["out_proj"]
    return out, {"conv": conv_state, "h": h_last}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {"conv": torch.zeros(batch, cfg.ssm_conv - 1, cfg.d_inner,
                                dtype=dtype, device=device),
            "h": torch.zeros(batch, cfg.d_inner, cfg.ssm_state,
                             dtype=torch.float32, device=device)}
