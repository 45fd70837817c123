"""Model blocks (counterpart of ``repro.models.layers``): attention, the
SwiGLU MLP, Mamba-1 and the RG-LRU.

Conventions as the reference's: x is (B, S, d); decode calls use S == 1
plus a cache. An attention cache is a ring buffer ``{"k", "v": (B, L,
KV, hd)`` in the model dtype, ``"pos": (B, L)`` int32``}`` holding each
slot's absolute position (-1 when empty), so decode writes position p to
slot p % L and masks by the stored positions; a Mamba cache is
``{"conv": (B, K-1, d_inner)`` in the model dtype, ``"h": (B, d_inner,
n)`` in f32``}``; an RG-LRU cache ``{"conv": (B, K-1, w)``, ``"h": (B,
w)`` in f32``}``. Caches are not updated in place: each call returns new
tensors, as the reference's functional updates do. Attention is plain
torch products op for op as the reference's ``_attend_einsum`` (scores
in f32, the NEG_INF mask, softmax, probabilities back in the model
dtype): it is jnp code there, not a Pallas kernel. ``flags`` holds
runtime options:

  * ``cache_len`` — set by ``api.prefill``: the length of the caches a
    prefill writes;
  * ``attn_impl`` — ``"einsum"`` (the default); ``"chunked"`` (the
    reference's online-softmax ``_attend_chunked``) is not ported yet and
    raises;
  * ``mamba_kernel`` — the Mamba scan goes to ``kernels.ops.selective_scan``
    (the hand-written CUDA kernel on the card); with ``use_kernel=False``
    there it runs the kernel's plain version, which gives the same bits;
  * ``mamba_fused`` (default True) — the chunked Mamba scan with the
    C-projection fused into the chunk loop, in plain PyTorch;
  * neither — the materialised route through ``linear_scan_chunked``;
  * ``rglru_kernel`` (default False) — the RG-LRU recurrence of a prefill
    goes to ``kernels.ops.linear_scan`` (the CUDA kernel on the card; its
    plain version under ``use_kernel=False``); otherwise
    ``linear_scan_chunked``, as the reference runs it;
  * ``scan_chunk`` — the chunk of the plain chunked routes (default 128
    for Mamba, 256 for the RG-LRU, the reference's).

MoE blocks are not ported yet (ROADMAP Queue 1 item 10); their entry
points raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops as kops
from .common import (ModelConfig, ParamInit, ParamModule, gelu, rms_norm,
                     rope, silu, softplus)

NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 item 10: the model zoo; "
              "the port runs dense attention and MLP, Mamba-1 and RG-LRU "
              "layers)")
CHUNKED_ATTENTION = ("the chunked (online-softmax) attention is not ported "
                     "yet (ROADMAP Queue 1 item 10, step 1: "
                     "_attend_chunked); use attn_impl='einsum'")
NEG_INF = -1e30


def _not_ported(block: str):
    def fn(*args, **kw):
        raise NotImplementedError(f"{block} {NOT_PORTED}")
    fn.__name__ = block
    return fn


init_moe = moe_apply = _not_ported("the MoE block")


# =============================================================== attention

def init_attention(init: ParamInit, p: ParamModule, cfg: ModelConfig) -> None:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p.param(init, "wq", (d, H, hd))
    p.param(init, "wk", (d, KV, hd))
    p.param(init, "wv", (d, KV, hd))
    p.param(init, "wo", (H, hd, d))
    if cfg.qk_norm:
        p.param(init, "q_norm", (hd,), init="ones")
        p.param(init, "k_norm", (hd,), init="ones")


def _qk_normalize(cfg: ModelConfig, p, q, k):
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def _attend_einsum(q, k, v, mask):
    """q: (B, S, H, hd), k/v: (B, T, KV, hd), mask: (B, 1, S, T) ->
    (B, S, H, hd); query head h reads KV head h // (H / KV)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scale = torch.sqrt(torch.tensor(float(hd), device=q.device)).to(q.dtype)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / scale
    scores = scores.float()
    scores = torch.where(mask[:, 0][:, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def _causal_mask(positions_q: torch.Tensor, positions_k: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """(B, 1, S, T) mask: causal, optionally sliding-window, k-pos >= 0."""
    pk = positions_k[:, None, None, :]
    pq = positions_q[:, None, :, None]
    m = (pk <= pq) & (pk >= 0)
    if window is not None:
        m &= pq - pk < window
    return m


def attention_apply(cfg: ModelConfig, p, x: torch.Tensor,
                    positions: torch.Tensor, *, kind: str = "global",
                    cache: Optional[dict] = None, mode: str = "train",
                    flags: Optional[dict] = None):
    """Causal self-attention, sliding-window for ``kind="local"``
    (``repro.models.layers.attention_apply``). ``mode="train"`` and
    ``"prefill"`` attend over the whole sequence; a prefill also returns
    the cache it fills (``flags["cache_len"]`` long, default S). ``"decode"``
    (S == 1) writes the token's k, v and position into its ring slot of
    ``cache`` and attends over the cache. Returns (y, new_cache or None).
    """
    flags = flags or {}
    if flags.get("attn_impl", "einsum") != "einsum":
        raise NotImplementedError(CHUNKED_ATTENTION)
    if kind not in ("global", "local"):
        raise NotImplementedError(f"{kind} attention {NOT_PORTED}")
    B, S, _ = x.shape
    window = cfg.window_size if kind == "local" else None
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q, k = _qk_normalize(cfg, p, q, k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode attends one token against a cache")
        L = cache["k"].shape[1]
        slot = positions[:, 0].long() % L                 # ring slot per row
        bidx = torch.arange(B, device=x.device)
        ck = cache["k"].index_put((bidx, slot), k[:, 0])
        cv = cache["v"].index_put((bidx, slot), v[:, 0])
        cpos = cache["pos"].index_put((bidx, slot),
                                      positions[:, 0].to(torch.int32))
        out = _attend_einsum(q, ck, cv, _causal_mask(positions, cpos, window))
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
        return y, {"k": ck, "v": cv, "pos": cpos}

    mask = _causal_mask(positions, positions, window)
    out = _attend_einsum(q, k, v, mask)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if mode != "prefill":
        return y, None
    pos = positions.to(torch.int32)
    cache_len = flags.get("cache_len", S)
    if cache_len >= S:
        # the reference pads every layer to the model-wide cache_len, a
        # local layer's too (ROADMAP Queue 3)
        pad = cache_len - S
        ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cpos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    else:
        # only the last cache_len keys, each in its ring slot
        # (pos % cache_len), so that decode's writes line up
        ck0, cv0 = k[:, -cache_len:], v[:, -cache_len:]
        cpos0 = pos[:, -cache_len:]
        bidx = torch.arange(B, device=x.device)[:, None]
        slots = (cpos0 % cache_len).long()
        ck = torch.zeros_like(ck0).index_put((bidx, slots), ck0)
        cv = torch.zeros_like(cv0).index_put((bidx, slots), cv0)
        cpos = torch.full_like(cpos0, -1).index_put((bidx, slots), cpos0)
    return y, {"k": ck, "v": cv, "pos": cpos}


def init_attention_cache(cfg: ModelConfig, batch: int, cache_len: int,
                         dtype, device) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros(batch, cache_len, KV, hd, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, cache_len, KV, hd, dtype=dtype,
                             device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}


# ==================================================================== MLP

def init_mlp(init: ParamInit, p: ParamModule, cfg: ModelConfig) -> None:
    d, f = cfg.d_model, cfg.d_ff
    p.param(init, "w_gate", (d, f))
    p.param(init, "w_up", (d, f))
    p.param(init, "w_down", (f, d))


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = silu(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
    h = h * torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


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
        if dt.requires_grad:
            raise NotImplementedError(
                "the selective-scan kernel has no backward (nor has the "
                "reference's); train Mamba layers on the fused or "
                "materialised route, or serve under torch.no_grad()")
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


# ================================================================== RG-LRU

def init_rglru(init: ParamInit, p: ParamModule, cfg: ModelConfig) -> None:
    d, w, K = cfg.d_model, cfg.lru_dim, cfg.conv1d_width
    p.param(init, "w_branch", (d, w))
    p.param(init, "w_gate_branch", (d, w))
    p.param(init, "conv_w", (K, w), scale=0.5)
    p.param(init, "conv_b", (w,), init="zeros")
    p.param(init, "w_a", (w, w), scale=0.02)
    p.param(init, "b_a", (w,), init="zeros")
    p.param(init, "w_i", (w, w), scale=0.02)
    p.param(init, "b_i", (w,), init="zeros")
    p.param(init, "lambda_p", (w,), init="lru_a")
    p.param(init, "out_proj", (w, d))


def rglru_apply(cfg: ModelConfig, p, x: torch.Tensor,
                cache: Optional[dict] = None, mode: str = "train",
                flags: Optional[dict] = None):
    """Griffin recurrent block: conv1d, then the RG-LRU gated diagonal
    recurrence h_t = a_t h_{t-1} + b_t in f32
    (``repro.models.layers.rglru_apply``). Returns (out (B, S, d),
    {"conv": ..., "h": ...})."""
    flags = flags or {}
    B, S, _ = x.shape
    xb = torch.einsum("bsd,dw->bsw", x, p["w_branch"])
    gate = gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate_branch"]))
    conv_state = cache["conv"] if cache is not None else None
    xb, conv_state = causal_conv1d(xb, p["conv_w"], p["conv_b"], conv_state)
    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", xb, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", xb, p["w_i"]) + p["b_i"])
    log_a = -8.0 * softplus(p["lambda_p"].float()) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    b = mult * (i * xb).float()
    h0 = (cache["h"] if cache is not None
          else x.new_zeros(B, cfg.lru_dim, dtype=torch.float32))
    if mode == "decode" and S == 1:
        h_last = a[:, 0] * h0 + b[:, 0]
        h_all = h_last[:, None]
    elif flags.get("rglru_kernel", False):
        if a.requires_grad or b.requires_grad:
            raise NotImplementedError(
                "the linear-scan kernel has no backward (nor has the "
                "reference's); train RG-LRU layers on the chunked route "
                "(rglru_kernel off), or serve under torch.no_grad()")
        h_all, h_last = kops.linear_scan(
            a.contiguous(), b.contiguous(), h0.contiguous(),
            use_kernel=flags.get("use_kernel", True))
    else:
        h_all, h_last = linear_scan_chunked(
            a, b, h0, chunk=flags.get("scan_chunk", 256))
    y = h_all.to(x.dtype) * gate
    out = torch.einsum("bsw,wd->bsd", y, p["out_proj"])
    return out, {"conv": conv_state, "h": h_last}


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {"conv": torch.zeros(batch, cfg.conv1d_width - 1, cfg.lru_dim,
                                dtype=dtype, device=device),
            "h": torch.zeros(batch, cfg.lru_dim, dtype=torch.float32,
                             device=device)}
