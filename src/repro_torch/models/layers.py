"""Model blocks (counterpart of ``repro.models.layers``): attention, the
SwiGLU MLP, the top-k MoE block, Mamba-1 and the RG-LRU.

Conventions as the reference's: x is (B, S, d); decode calls use S == 1
plus a cache. An attention cache is a ring buffer ``{"k", "v": (B, L,
KV, hd)`` in the model dtype, ``"pos": (B, L)`` int32``}`` holding each
slot's absolute position (-1 when empty), so decode writes position p to
slot p % L and masks by the stored positions; a Mamba cache is
``{"conv": (B, K-1, d_inner)`` in the model dtype, ``"h": (B, d_inner,
n)`` in f32``}``; an RG-LRU cache ``{"conv": (B, K-1, w)``, ``"h": (B,
w)`` in f32``}``. Caches are not updated in place: each call returns new
tensors, as the reference's functional updates do. Attention and the MoE
block are plain torch products op for op as the reference's jnp code
(no Pallas kernel there): ``_attend_einsum`` materialises the f32
scores, ``_attend_chunked`` runs the online softmax over key chunks of
512, its running output in the model dtype. ``flags`` holds runtime
options:

  * ``cache_len`` — set by ``api.prefill``: the length of the caches a
    prefill writes;
  * ``attn_impl`` — ``"einsum"`` (the default) or ``"chunked"``;
  * ``moe_impl`` — ``"auto"`` (the default) or ``"ep"``, expert
    parallelism over the "data" axis of ``flags["mesh"]``: under
    ``_in_manual`` (the mesh train step) always, under a mesh alone (the
    serve steps) when the experts split over the axis, as the rules cut
    them; otherwise ``"ep"`` falls through to ``"auto"``, as the
    reference's does; ``moe_a2a_quant`` sends its exchanges as int8
    codes;
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

The front ends' attention: the bidirectional ``"encoder"`` kind (every
mask entry true, q/k-norm and rope as the decoder's) and cross-attention
to an encoder memory (``cross_kv``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import dist
from ..kernels import ops as kops
from .common import (ModelConfig, ParamInit, ParamModule, gelu, rms_norm,
                     rope, silu, softplus)

EP_NOT_PORTED = ("the expert-parallel MoE over a mesh whose 'model' axis "
                 "has more than one rank (tensor parallelism inside the "
                 "experts) is not ported yet: ROADMAP Queue 1 item 10 "
                 "step 6, part B (3), the 'model' axis")
NEG_INF = -1e30


# =============================================================== attention

def init_attention(init: ParamInit, p: ParamModule, cfg: ModelConfig) -> None:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p.param(init, "wq", (d, H, hd), ("embed", "heads", "head_dim"))
    p.param(init, "wk", (d, KV, hd), ("embed", "kv_heads", "head_dim"))
    p.param(init, "wv", (d, KV, hd), ("embed", "kv_heads", "head_dim"))
    p.param(init, "wo", (H, hd, d), ("heads", "head_dim", "embed"))
    if cfg.qk_norm:
        p.param(init, "q_norm", (hd,), ("head_dim",), init="ones")
        p.param(init, "k_norm", (hd,), ("head_dim",), init="ones")


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


def _attend_chunked(q, k, v, mask, chunk: int = 512):
    """Flash-style online softmax over key chunks (the reference's
    ``_attend_chunked``): one (S, chunk) block of scores at a time, never
    (S, T). Op for op as the reference: q divided by sqrt(hd) in its dtype
    before the product; k, v padded with zeros and the mask with False to
    whole chunks of ``min(chunk, T)``; the running max from NEG_INF and
    the running sum in f32; the running output in q's dtype, rescaled by
    alpha cast to it; the output divided by max(l, 1e-30). A chunk that
    is fully masked before a row's first unmasked key adds exp(0) = 1 a
    key to l and o, as the reference's does; the first unmasked key's
    max then rescales that to 0. Same shapes as ``_attend_einsum``."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk = min(chunk, T)
    pad = -T % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    scale = torch.sqrt(torch.tensor(float(hd), device=q.device)).to(q.dtype)
    # (B, KV, G*S, hd): query head h = kv * G + g reads KV head kv
    qg = (q.reshape(B, S, KV, G, hd) / scale).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, KV, G * S, hd)
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, KV, G, S, hd), dtype=q.dtype, device=q.device)
    for t0 in range(0, T + pad, chunk):
        k_i = k[:, t0:t0 + chunk].permute(0, 2, 3, 1)         # (B,KV,hd,c)
        v_i = v[:, t0:t0 + chunk].permute(0, 2, 1, 3)         # (B,KV,c,hd)
        keep = mask[:, 0, None, None, :, t0:t0 + chunk]       # (B,1,1,S,c)
        s = torch.matmul(qg, k_i).view(B, KV, G, S, chunk).float()
        s = s.masked_fill_(~keep, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        if s.requires_grad:
            pexp = torch.exp(s - m_new[..., None])
        else:                       # serving: the scores' memory is reused
            pexp = s.sub_(m_new[..., None]).exp_()
        l = l * alpha + torch.sum(pexp, dim=-1)
        o_i = torch.matmul(pexp.to(q.dtype).view(B, KV, G * S, chunk), v_i)
        del s, pexp          # before the next chunk's scores are made
        o = o * alpha[..., None].to(q.dtype) + o_i.view(B, KV, G, S, hd)
        m = m_new
    out = o / torch.clamp_min(l, 1e-30)[..., None].to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


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
                    flags: Optional[dict] = None,
                    cross_kv: Optional[torch.Tensor] = None):
    """Causal self-attention, sliding-window for ``kind="local"``,
    bidirectional for ``kind="encoder"``
    (``repro.models.layers.attention_apply``). ``mode="train"`` and
    ``"prefill"`` attend over the whole sequence; a prefill also returns
    the cache it fills (``flags["cache_len"]`` long, default S). ``"decode"``
    (S == 1) writes the token's k, v and position into its ring slot of
    ``cache`` and attends over the cache. ``flags["attn_impl"] ==
    "chunked"`` attends by ``_attend_chunked`` in every mode, anything
    else by ``_attend_einsum``, as the reference routes.

    ``cross_kv`` (B, T_enc, d), an encoder memory, makes it
    cross-attention: q from x, k and v from the memory, no rope, no
    q/k-norm, every (query, key) pair unmasked, in every mode; the cache
    comes back as it was given (the reference recomputes the memory's
    k and v at every decode step, and so does the port). Returns (y,
    new_cache or None).
    """
    flags = flags or {}
    attend = (_attend_chunked if flags.get("attn_impl", "einsum") == "chunked"
              else _attend_einsum)
    B, S, _ = x.shape
    window = cfg.window_size if kind == "local" else None
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cross_kv is not None:
        k = torch.einsum("bsd,dhk->bshk", cross_kv, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", cross_kv, p["wv"])
        mask = torch.ones((B, 1, S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = attend(q, k, v, mask)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache
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
        out = attend(q, ck, cv, _causal_mask(positions, cpos, window))
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
        return y, {"k": ck, "v": cv, "pos": cpos}

    if kind == "encoder":                                # bidirectional
        mask = torch.ones((B, 1, S, S), dtype=torch.bool, device=x.device)
    else:
        mask = _causal_mask(positions, positions, window)
    out = attend(q, k, v, mask)
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
    p.param(init, "w_gate", (d, f), ("embed", "mlp"))
    p.param(init, "w_up", (d, f), ("embed", "mlp"))
    p.param(init, "w_down", (f, d), ("mlp", "embed"))


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = silu(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
    h = h * torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


# ==================================================================== MoE

def init_moe(init: ParamInit, p: ParamModule, cfg: ModelConfig) -> None:
    """The router (d, E) at scale 0.02 and the experts' SwiGLU weights
    (E, d, f), (E, d, f), (E, f, d) at ParamInit's default 1/sqrt(E), as
    the reference's ``ParamBuilder`` scales a leaf by its first axis."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p.param(init, "router", (d, E), ("embed", "experts_router"), scale=0.02)
    p.param(init, "w_gate", (E, d, f), ("experts", "embed", "expert_mlp"))
    p.param(init, "w_up", (E, d, f), ("experts", "embed", "expert_mlp"))
    p.param(init, "w_down", (E, f, d), ("experts", "expert_mlp", "embed"))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, descending,
    the lower index first among equal values. ``torch.topk`` promises no
    order among ties, so a stable descending sort picks them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(xf: torch.Tensor, router) -> torch.Tensor:
    """Router logits in f32 and their softmax, written as ``jax.nn.softmax``
    computes it: exp(x - max) over its sum. (T, E)."""
    logits = (xf @ router).float()
    z = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return z / torch.sum(z, dim=-1, keepdim=True)


def _moe_route(cfg: ModelConfig, probs: torch.Tensor, xf: torch.Tensor,
               C: int):
    """``_moe_dispatch`` from the router's probabilities on: the top-k,
    the sort, the capacity and the buffer."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    gate_vals, eids = _top_k(probs, k)                          # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    flat_e = eids.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    tok = order // k
    starts = torch.searchsorted(se, torch.arange(E, device=xf.device))
    pos = torch.arange(T * k, device=xf.device) - starts[se]
    valid = pos < C
    dest = se * C + torch.where(valid, pos, 0)
    # a dropped assignment adds +0.0 to its expert's slot 0, as the
    # reference's does: each valid slot is written once, onto +0.0
    src = torch.where(valid[:, None], xf[tok], xf.new_zeros(()))
    buf = xf.new_zeros(E * C, d).index_add_(0, dest, src)
    dispatch_frac = torch.mean(
        torch.nn.functional.one_hot(eids[:, 0], E).float(), dim=0)
    prob_frac = torch.mean(probs, dim=0)
    aux = E * torch.sum(dispatch_frac * prob_frac)
    combine = (tok, dest, valid, gate_vals.reshape(-1)[order])
    return buf.view(E, C, d), combine, aux


def _moe_dispatch(cfg: ModelConfig, router, xf: torch.Tensor, C: int):
    """Sort-based routing (the reference's ``_moe_dispatch``). Returns
    (buf (E, C, d), combine, aux): each (token, expert) assignment, sorted
    stably by expert id, takes slot ``pos`` of its expert when pos < C
    and is dropped otherwise, so an expert keeps its lowest token indices;
    combine = (tok, dest, valid, gates) in that sorted order; aux is the
    switch load-balance term E * sum(top-1 share * mean prob), in f32."""
    return _moe_route(cfg, _router_probs(xf, router), xf, C)


def _moe_combine(combine, out_buf: torch.Tensor, T: int, dtype):
    """Each token's k expert outputs times (valid * gate) cast to
    ``dtype``, added one after another onto zeros in ``dtype``, in the
    sorted order (ascending expert id): the order in which the reference's
    ``.at[tok].add`` applies them. No atomics, so the sum is the same on
    every run and device."""
    tok, dest, valid, gates = combine
    d = out_buf.shape[-1]
    flat = out_buf.reshape(-1, d)
    w = (valid * gates).to(dtype)
    # (T, k): the sorted positions of each token's assignments, ascending
    slots = torch.argsort(tok, stable=True).view(T, -1)
    y = torch.zeros((T, d), dtype=dtype, device=out_buf.device)
    for j in range(slots.shape[1]):
        i = slots[:, j]
        y = y + flat[dest[i]] * w[i, None]
    return y


def _capacity(cfg: ModelConfig, T: int) -> int:
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    if T * k <= 256:
        # dropless small-batch path (decode): full capacity, so routing
        # is exactly that of the large-batch forward pass
        return T * k
    return max(1, int(T * k * cfg.moe_capacity_factor / E))


def _expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert over its (C, d) slots: (E, C, d) -> (E, C, d)."""
    h = silu(torch.bmm(buf, p["w_gate"]))
    h = h * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _ep_axis(cfg: ModelConfig, p, flags: dict):
    """(group, n) of the "data" axis when the expert-parallel route runs,
    None for the auto route. The route is the one the sharding rules
    chose: EP under ``_in_manual``, or under a mesh whose "data" axis
    divides E; then the block must hold E / n experts. A block holding a
    share of the experts never takes the auto route."""
    E, held = cfg.n_experts, p["w_gate"].shape[0]
    mesh = flags.get("mesh")
    if flags.get("moe_impl", "auto") == "ep" and (
            flags.get("_in_manual") or mesh is not None):
        if mesh is None or "data" not in mesh.axis_names:
            raise ValueError("the expert-parallel route runs over the "
                             "'data' axis of flags['mesh']")
        if mesh.shape.get("model", 1) > 1:
            raise NotImplementedError(EP_NOT_PORTED)
        n = mesh.shape["data"]
        if flags.get("_in_manual") or E % n == 0:
            if held * n != E:
                raise ValueError(
                    f"the expert-parallel route over {n} ranks needs {E}/{n}"
                    f" experts a rank, this block holds {held}: build the "
                    f"model with launch.sharding.Placement(mesh)")
            return dist.axis_group(mesh, "data"), n
    if held != E:
        raise ValueError(f"this block holds {held} of {E} experts, so it "
                         f"runs only on the expert-parallel route "
                         f"(moe_impl='ep' with its mesh)")
    return None


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor,
              flags: Optional[dict] = None, *, aux: bool = True):
    """Top-k MoE with sort-based dispatch and a fixed capacity per expert
    (``repro.models.layers.moe_apply``). On the ``"auto"`` route every
    expert runs over its whole (C, d) buffer, filled or not; on the
    expert-parallel one (``_ep_axis``) :func:`_moe_apply_ep`. Returns (y
    (B, S, d), aux). ``aux=False`` says the caller drops aux (a prefill
    or decode step): the expert-parallel route then skips its mean over
    the ranks, a collective a layer, and returns None for it."""
    flags = flags or {}
    ep = _ep_axis(cfg, p, flags)
    if ep is not None:
        return _moe_apply_ep(cfg, p, x, *ep,
                             quant=bool(flags.get("moe_a2a_quant", False)),
                             aux=aux)
    B, S, d = x.shape
    T = B * S
    C = _capacity(cfg, T)
    buf, combine, aux = _moe_dispatch(cfg, p["router"], x.reshape(T, d), C)
    y = _moe_combine(combine, _expert_ffn(p, buf), T, x.dtype)
    return y.view(B, S, d), aux


def _a2a_codes(u: torch.Tensor):
    """The int8 exchange's payload of ``u`` (n, ...): per-source absmax
    scales (n, 1, ...) (the max in u's dtype, then f32) and codes
    round(u / max(scale, 1e-30) * 127) clipped to [-127, 127], in f32
    (round half to even), as the reference's ``_a2a_quantized``."""
    scale = u.abs().amax(dim=tuple(range(1, u.dim())), keepdim=True).float()
    q = torch.round(u.float() / torch.clamp_min(scale, 1e-30) * 127.0)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


class _A2AQuantized(torch.autograd.Function):
    """The int8 all-to-all (``repro.models.layers._a2a_quantized``): the
    codes and the f32 scales are exchanged, then dequantised in f32 and
    cast back to u's dtype. The reference writes codes * scale / 127;
    XLA turns the division by the constant into a product with its f32
    reciprocal, and so does the port, for the same bits. The backward
    pass is the plain exchange of the gradient (straight through)."""

    @staticmethod
    def forward(ctx, u, group, size):
        ctx.group, ctx.size = group, size
        q, scale = _a2a_codes(u)
        q = dist.all_to_all(q, group, size=size)
        scale = dist.all_to_all(scale, group, size=size)
        return (q.float() * scale * (1.0 / 127.0)).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        return dist.all_to_all(g, ctx.group, size=ctx.size), None, None


def _a2a_quantized(u: torch.Tensor, group, size: int) -> torch.Tensor:
    return _A2AQuantized.apply(u, group, size)


def _moe_apply_ep(cfg: ModelConfig, p, x: torch.Tensor, group, n: int,
                  quant: bool = False, aux: bool = True):
    """The expert-parallel block (``repro.models.layers._moe_apply_ep``),
    p holding this rank's E/n experts (rank i holds experts [i E/n,
    (i+1) E/n)): route this rank's tokens with the replicated router at
    capacity ``_capacity(cfg, T_local)`` per (source, expert); exchange
    the (n, E/n, C, d) buffer with :func:`core.dist.all_to_all` (int8
    codes with ``quant``); run the local experts over (E/n, n C, d), the
    sources in rank order; exchange back and combine. aux is the mean of
    the ranks' load-balance terms (the reference's ``pmean``), None with
    ``aux=False``."""
    B, S, d = x.shape
    T = B * S
    E_loc = cfg.n_experts // n
    C = _capacity(cfg, T)
    buf, combine, local_aux = _moe_dispatch(cfg, p["router"],
                                            x.reshape(T, d), C)

    def exchange(t):
        return (_a2a_quantized(t, group, n) if quant
                else dist.all_to_all(t, group, size=n))

    buf = exchange(buf.reshape(n, E_loc, C, d))
    buf = buf.transpose(0, 1).reshape(E_loc, n * C, d)
    out = _expert_ffn(p, buf)
    out = exchange(out.view(E_loc, n, C, d).transpose(0, 1).contiguous())
    y = _moe_combine(combine, out.view(cfg.n_experts, C, d), T, x.dtype)
    return y.view(B, S, d), (dist.all_mean(local_aux, group, n) if aux
                             else None)


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
    p.param(init, "in_proj", (d, 2 * di), ("embed", "ssm_inner"))
    p.param(init, "conv_w", (K, di), ("conv", "ssm_inner"), scale=0.5)
    p.param(init, "conv_b", (di,), ("ssm_inner",), init="zeros")
    p.param(init, "x_proj", (di, dr + 2 * n), ("ssm_inner", "dt_rank"))
    p.param(init, "dt_proj", (dr, di), ("dt_rank", "ssm_inner"))
    p.param(init, "dt_bias", (di,), ("ssm_inner",), init="zeros")
    p.param(init, "a_log", (di, n), ("ssm_inner", "ssm_state"), init="ssm_a")
    p.param(init, "d_skip", (di,), ("ssm_inner",), init="ones")
    p.param(init, "out_proj", (di, d), ("ssm_inner", "embed"))


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
    p.param(init, "w_branch", (d, w), ("embed", "lru"))
    p.param(init, "w_gate_branch", (d, w), ("embed", "lru"))
    p.param(init, "conv_w", (K, w), ("conv", "lru"), scale=0.5)
    p.param(init, "conv_b", (w,), ("lru",), init="zeros")
    p.param(init, "w_a", (w, w), ("lru", "lru"), scale=0.02)
    p.param(init, "b_a", (w,), ("lru",), init="zeros")
    p.param(init, "w_i", (w, w), ("lru", "lru"), scale=0.02)
    p.param(init, "b_i", (w,), ("lru",), init="zeros")
    p.param(init, "lambda_p", (w,), ("lru",), init="lru_a")
    p.param(init, "out_proj", (w, d), ("lru", "embed"))


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
