"""Monte-Carlo FL simulation engine (counterpart of ``repro.fl.engine``).

Runs the paper's (trials, rounds) recursion of eq. (2)/(13) with trials
as the leading dimension of every tensor (the reference's ``vmap``) and
rounds as a Python loop (its ``lax.scan``). Each round: f32 device
gradients of the f64 model, one scheme round (the OTA epilogue and the
digital quantizer run as CUDA kernels on the card), then the projected
f64 SGD step. The eval-segment structure and the time-budget freeze are
the reference's (``repro/fl/engine.py:746-907``): cumulative wall-clock
rides per trial, a round runs iff the wall-clock before it is under the
budget, and each eval reports the last live model.

Two random-stream modes, as the reference's (``run(..., rng=...)``):

  * ``rng="replay"`` (default) replays the reference's replay mode bit
    for bit: fading from ``channel.sample_fading_batch(lambdas,
    seed*1000 + trial, T)``, PS AWGN from ``trial_rng(seed,
    trial).standard_normal((T, d))``, the digital baselines' selection
    draws from the same sequential generator through each port's
    ``sel_stream_np`` (all NumPy, made on the host and copied to the
    device once per run);
  * ``rng="fast"`` draws the fading (``channel.fading_abs_fast``), the
    PS AWGN (``rngstream.noise_blocks``) and the selection rows (each
    port's ``sel_stream_fast``) from the counter-based threefry streams
    of ``(seed, trial, round)``, tags 43, 41 and 47, on the device with
    no host precompute: the reference's fast mode, the same law as
    replay but another stream.

In both modes the dither (``rngstream.dither_blocks``, one (trials, N, d)
block a round), the mini-batch indices and the layers' uniforms are
counter-based and the same. Mini-batches (``batch_size``) follow the
reference's three regimes (``repro/fl/engine.py:590-689``): devices of
equal size draw ``rngstream.batch_blocks`` rows from one stacked
(N, n, F) array; unequal sizes zero-pad the stacks to the largest, each
row drawing from its own size (ragged); and where the batch covers some
device (mixed), that device gathers its whole dataset and the gradient
weighs each row (1/n_m on its real rows, 0 on the duplicates, 1/B on a
drawn batch) through ``task.device_grads_at_weighted``. The draws are
made a chunk of rounds at a time on the device.

The reference's robustness layers transform each round's payloads
upstream of every scheme's combiner, in its order (``repro/fl/engine.py:
796-848``): the bf16 payload cast; partial participation (``chi = u <
pi``, the included rows scaled by N/S); buffered async
(``core.async_fl.async_round`` over a (trials, K, N, d) buffer, then a
zero fill or ``stale_replace``); faults (``core.faults.fault_masks``,
then ``reweight`` by ok/q, ``zero`` by ok or ``stale``). Their uniforms
come from counter-based threefry streams (tags 53, 59, 61), made for the
whole run in one pass on the device and widened to f64 exactly, so every
mask is an exact comparison against float64 tables. A disabled
``FaultSpec``, ``clients_per_round=None`` and ``mode="sync"`` each
normalize to no layer, and the round runs the program without it. Under
faults a round in which a delivering straggler takes part is stretched
by ``straggler_mult`` and a deadline caps it, per trial on the device.

The engine covers both modes, full and mini-batches for all 15 Sec. V
schemes on one device; trials across cards (``shard_trials=True``)
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import async_fl
from ..core import baselines as B
from ..core import participation as participation_lib
from ..core import rngstream
from ..core.channel import (Deployment, fading_abs_fast,
                            sample_fading_batch)
from ..core.digital import (alloc_latency, capacity_rate, digital_round,
                            greedy_bit_alloc, outage_mask, sum_in_order,
                            topk_mask)
from ..core.faults import fault_masks, survival_prob
from ..core.ota import (bbfl_round, opc_ota_comp_eta, opc_ota_fl_round,
                        ota_round)
from ..core.quantize import payload_bits
from ..device import resolve_device
from ..kernels import ops

_LATER = ("ROADMAP Queue 1 item 10 step 6 (multi-card: trials across "
          "cards)")

#: entries of one chunk of a stream's rounds (``_Chunked``)
_CHUNK_ENTRIES = 1 << 22


@dataclasses.dataclass
class TrainLog:
    scheme: str
    rounds: np.ndarray          # (T_eval,)
    wall_time_s: np.ndarray     # cumulative uplink latency at eval points
    global_loss: np.ndarray     # (trials, T_eval)
    accuracy: np.ndarray        # (trials, T_eval)
    opt_error: Optional[np.ndarray] = None   # ||w_t - w*||^2 if w* known

    def mean_std(self, field: str):
        v = getattr(self, field)
        return v.mean(axis=0), v.std(axis=0)

    def final_accuracy(self) -> float:
        return float(self.accuracy[:, -1].mean())


@dataclasses.dataclass
class SchemePort:
    """A scheme in functional form: ``round_fn(grads (K,N,d) f64,
    habs (K,N), z01 (K,d) or None, u (K,N,d) f32 or None, sel (K,S) or
    None, t) -> (ghat (K,d), latency)``; latency in channel uses for OTA
    schemes (divided by the bandwidth by the engine), in seconds for
    digital ones. ``t`` is the global round index (BB-FL Alternative's
    parity)."""

    name: str
    is_ota: bool
    round_fn: Callable
    needs_noise: bool = True
    needs_dither: bool = False
    # (seed, trial, T) -> (T, S) f64 replay of the per-round selection
    # draws the reference's scheme takes from the sequential trial
    # generator (``rngstream.replay_rounds``); None when it draws none
    sel_stream_np: Optional[Callable[[int, int, int], np.ndarray]] = None
    # (trials, T, S) replayed draws -> the (trials, T, S') rows round_fn
    # reads as ``sel``, on the host once per run (FedTOE's allocation)
    sel_plan: Optional[Callable[[np.ndarray], np.ndarray]] = None
    # fast-mode analog of sel_stream_np (the reference's sel_stream_jax):
    # round-folded SELECT_TAG keys, a pair of int64 (..., 1) tensors ->
    # (..., S) f64 rows in sel_stream_np's layout, made on the device
    sel_stream_fast: Optional[Callable] = None


# ------------------------------------------------------- OTA scheme ports
#
# Counterparts of ``repro/fl/engine.py:183-310``, batched over trials.

def _ideal_fedavg(agg, use_kernel):
    return SchemePort(agg.name, True,
                      lambda g, habs, z01, u, sel, t: (g.mean(-2), 0.0),
                      needs_noise=False)


def _from_ota_params(agg, use_kernel):
    params = agg.params

    def round_fn(g, habs, z01, u, sel, t):
        ghat, _ = ota_round(params, g, habs, z01, use_kernel=use_kernel)
        return ghat, float(params.dim)

    return SchemePort(agg.name, True, round_fn)


def _vanilla_ota(agg, use_kernel):
    root_des = float(np.sqrt(agg.dim * agg.e_s))
    root_n0 = float(np.sqrt(agg.n0))

    def round_fn(g, habs, z01, u, sel, t):
        # per-trial gamma_t: the epilogue takes one inv_alpha per row
        gamma_t = root_des * habs.amin(-1) / agg.g_max
        acc = gamma_t[:, None] * g.sum(-2)
        ghat = ops.ota_combine_with_noise(acc, g.shape[-2] * gamma_t,
                                          root_n0 * z01,
                                          use_kernel=use_kernel)
        return ghat, float(agg.dim)

    return SchemePort(agg.name, True, round_fn)


def _opc_ota_comp(agg, use_kernel):
    dim, g_max, e_s, n0 = agg.dim, agg.g_max, agg.e_s, agg.n0
    b_bar = float(np.sqrt(dim * e_s) / g_max)
    root_n0 = float(np.sqrt(n0))

    def round_fn(g, habs, z01, u, sel, t):
        eta = opc_ota_comp_eta(habs, dim=dim, g_max=g_max, e_s=e_s, n0=n0,
                               n_grid=agg.n_grid)
        b_t = torch.clamp(torch.sqrt(eta)[..., None] / habs, max=b_bar)
        acc = ((b_t * habs).unsqueeze(-2) @ g).squeeze(-2)
        ghat = ops.ota_combine_with_noise(acc, g.shape[-2] * torch.sqrt(eta),
                                          root_n0 * z01,
                                          use_kernel=use_kernel)
        return ghat, float(dim)

    return SchemePort(agg.name, True, round_fn)


def _opc_ota_fl(agg, use_kernel):
    kw = dict(dim=agg.dim, g_max=agg.g_max, e_s=agg.e_s, n0=agg.n0,
              use_kernel=use_kernel)

    def round_fn(g, habs, z01, u, sel, t):
        return opc_ota_fl_round(g, habs, z01, **kw)[0], float(agg.dim)

    return SchemePort(agg.name, True, round_fn)


def _bbfl_port(agg, use_kernel, odd, even):
    """BB-FL with the (gamma, mask) policy ``odd`` in odd rounds and
    ``even`` in even ones."""
    kw = dict(dim=agg.dim, g_max=agg.g_max, e_s=agg.e_s, n0=agg.n0,
              gamma_odd=odd[0], mask_odd=odd[1], gamma_even=even[0],
              mask_even=even[1], use_kernel=use_kernel)

    def round_fn(g, habs, z01, u, sel, t):
        return bbfl_round(g, habs, z01, t, **kw)[0], float(agg.dim)

    return SchemePort(agg.name, True, round_fn)


def _bbfl_interior(agg, use_kernel):
    policy = (agg.gamma, agg.interior)
    return _bbfl_port(agg, use_kernel, policy, policy)


def _bbfl_alternative(agg, use_kernel):
    inner = agg.interior_agg
    return _bbfl_port(agg, use_kernel, (inner.gamma, inner.interior),
                      (agg.gamma_all, agg.all_mask))


# --------------------------------------------------- digital scheme ports

def _proposed_digital(agg, use_kernel):
    params = agg.params

    def round_fn(g, habs, z01, u, sel, t):
        ghat, _, latency = digital_round(params, g, habs, u,
                                         use_kernel=use_kernel)
        return ghat, latency

    return SchemePort(agg.name, False, round_fn, needs_noise=False,
                      needs_dither=True)


def _quantized_mean(grads, chi, bits, u, k, use_kernel, r_max):
    """sum_{m in sel} dequant(quant(g_m, r_m)) / k (``repro/fl/engine.py:
    312-321``): k a number or one per trial. The levels 2^r - 1 are made
    with an integer shift, so they are exact integers (the reference's
    ``jnp.exp2`` is not, ROADMAP Queue 3). The route follows the payload
    (``ops.fused_route``), so the plain run takes the kernel run's."""
    one = torch.ones_like(bits, dtype=torch.int64)
    levels = chi * ((one << bits.to(torch.int64)) - 1).to(grads.dtype)
    weights = chi / (k[..., None] if torch.is_tensor(k) else k)
    return ops.quantized_weighted_sum(
        grads, levels, u, weights, r_max=r_max, use_kernel=use_kernel,
        fused=ops.fused_route(r_max, grads.shape[-1]))


def _capacity_latency(chi, payload, habs, agg):
    """sum_m chi_m L_m / (B max(R_m, 1e-9)) over the capacity rates R_m,
    devices added in index order."""
    rate = capacity_rate(habs, agg.e_s, agg.n0)
    return sum_in_order(chi * payload
                        / (agg.B * torch.clamp(rate, min=1e-9)))


def _best_channel(agg, use_kernel):
    k, r = agg.k, agg.r
    payload = float(payload_bits(agg.dim, r))

    def round_fn(g, habs, z01, u, sel, t):
        chi = topk_mask(habs, k).to(g.dtype)
        lat = _capacity_latency(chi, payload, habs, agg)
        return _quantized_mean(g, chi, chi * r, u, k, use_kernel, r), lat

    return SchemePort(agg.name, False, round_fn, needs_noise=False,
                      needs_dither=True)


def _prop_fairness(agg, use_kernel):
    k, r = agg.k, agg.r
    lambdas = np.asarray(agg.dep.lambdas)
    payload = float(payload_bits(agg.dim, r))

    def round_fn(g, habs, z01, u, sel, t):
        lam = torch.as_tensor(lambdas, device=habs.device)
        chi = topk_mask(habs * habs / lam, k).to(g.dtype)
        lat = _capacity_latency(chi, payload, habs, agg)
        return _quantized_mean(g, chi, chi * r, u, k, use_kernel, r), lat

    return SchemePort(agg.name, False, round_fn, needs_noise=False,
                      needs_dither=True)


def _best_channel_norm(agg, use_kernel):
    k, kp, r_total = agg.k, agg.kp, agg.r_total

    def round_fn(g, habs, z01, u, sel, t):
        cand = topk_mask(habs, kp)
        # per-device scores through the row-statistics kernel
        _, sumsq = ops.row_maxabs_sumsq(g, use_kernel=use_kernel)
        norms = torch.sqrt(sumsq)
        chi = topk_mask(torch.where(cand > 0, norms, -torch.inf),
                        k).to(g.dtype)
        share = (chi * norms) / torch.clamp(sum_in_order(chi * norms),
                                            min=1e-12)[..., None]
        bits = chi * torch.clamp(torch.round(r_total * share), min=1.0)
        lat = _capacity_latency(chi, 64.0 + agg.dim * bits, habs, agg)
        acc = _quantized_mean(g, chi, bits, u, k, use_kernel, r_total)
        return acc, lat

    return SchemePort(agg.name, False, round_fn, needs_noise=False,
                      needs_dither=True)


def _choice_stream(agg):
    """Replay of ``rng.choice(N, size=K, replace=False)`` once a round,
    and its fast form ``jax.random.choice(key, N, (K,), replace=False)``."""
    n, k = agg.dep.n_devices, agg.k

    def sel_stream(seed, trial, T):
        return rngstream.replay_rounds(
            seed, trial, T, lambda rng: rng.choice(n, size=k, replace=False))

    def sel_stream_fast(key):
        return rngstream.choice_without_replacement(
            key, n, k, device=key[0].device).to(torch.float64)

    return dict(sel_stream_np=sel_stream, sel_stream_fast=sel_stream_fast)


def _uqos(agg, use_kernel):
    k, r, rate_c = agg.k, agg.r, agg.rate
    pi = np.asarray(agg.pi)
    n = pi.shape[0]
    # unbiased reweighting 1 / (n pi p_succ), made on the host as the
    # reference's NumPy constants are
    inv_w = n * pi * np.asarray(agg.p_succ)
    payload = float(payload_bits(agg.dim, r))

    def sel_stream(seed, trial, T):
        # per round: sampling permutation + inclusion keys, in draw order
        def draw(rng):
            return np.concatenate([rng.permutation(n).astype(np.float64),
                                   rng.uniform(size=n)])
        return rngstream.replay_rounds(seed, trial, T, draw)

    def sel_stream_fast(key):
        # the replay row's layout: permutation, then inclusion keys
        kp, ku = rngstream.split(key, 2)
        dev = key[0].device
        return torch.cat([
            rngstream.permutation(kp, n, device=dev).to(torch.float64),
            rngstream.uniform_f64(ku, (n,), device=dev)], dim=-1)

    def round_fn(g, habs, z01, u, sel, t):
        pi_t = torch.as_tensor(pi, device=g.device)
        order = sel[..., :n].to(torch.int64)
        keys = sel[..., n:] ** (1.0 / pi_t[order])
        top = torch.argsort(keys, dim=-1, stable=True).flip(-1)[..., :k]
        chosen = order.gather(-1, top)
        cmask = torch.zeros_like(habs).scatter(-1, chosen, 1.0)
        snr_ok = capacity_rate(habs, agg.e_s, agg.n0) >= rate_c
        active = (cmask * snr_ok).to(g.dtype)
        levels = active * (2.0 ** r - 1.0)
        acc = ops.quantized_weighted_sum(
            g, levels, u, active / torch.as_tensor(inv_w, device=g.device),
            r_max=r, use_kernel=use_kernel,
            fused=ops.fused_route(r, g.shape[-1]))
        lat = active.sum(-1) * payload / (agg.B * rate_c)
        return acc, lat

    return SchemePort(agg.name, False, round_fn, needs_noise=False,
                      needs_dither=True, sel_stream_np=sel_stream,
                      sel_stream_fast=sel_stream_fast)


def _qml(agg, use_kernel):
    k, r = agg.k, agg.r
    payload = float(payload_bits(agg.dim, r))

    def round_fn(g, habs, z01, u, sel, t):
        chi = torch.zeros_like(habs).scatter(-1, sel.to(torch.int64), 1.0)
        chi = chi.to(g.dtype)
        lat = _capacity_latency(chi, payload, habs, agg)
        return _quantized_mean(g, chi, chi * r, u, k, use_kernel, r), lat

    return SchemePort(agg.name, False, round_fn, needs_noise=False,
                      needs_dither=True, **_choice_stream(agg))


def _fedtoe(agg, use_kernel):
    dim, bw, r_max = agg.dim, agg.B, agg.r_max
    rates = np.asarray(agg.rates)
    n = rates.shape[0]

    def sel_plan(sel):
        """(trials, T, k) draws -> (trials, T, 2N + 1) rows: the greedy
        allocation's bits and mask, and the round's TDMA latency."""
        out = np.zeros(sel.shape[:2] + (2 * n + 1,))
        for idx in np.ndindex(*sel.shape[:2]):
            bits, in_alloc = greedy_bit_alloc(
                sel[idx].astype(np.int64), rates, dim=dim, bandwidth_hz=bw,
                t_budget_s=agg.t_budget, r_max=r_max)
            lat = alloc_latency(bits, in_alloc, rates, dim=dim,
                                bandwidth_hz=bw)
            out[idx] = np.concatenate([bits, in_alloc, [lat]])
        return out

    def round_fn(g, habs, z01, u, sel, t):
        bits, in_alloc = sel[..., :n], sel[..., n:2 * n]
        chi = (in_alloc * outage_mask(habs, agg.thr)).to(g.dtype)
        k_sched = torch.clamp(in_alloc.sum(-1), min=1.0)
        acc = _quantized_mean(g, chi, chi * bits, u,
                              k_sched * (1.0 - agg.p_out), use_kernel, r_max)
        return acc, sel[..., 2 * n]

    return SchemePort(agg.name, False, round_fn, needs_noise=False,
                      needs_dither=True, sel_plan=sel_plan,
                      **_choice_stream(agg))


#: scheme type -> port factory ``(agg, use_kernel) -> SchemePort``
_PORTS = {
    B.IdealFedAvg: _ideal_fedavg, B.ProposedOTA: _from_ota_params,
    B.LCPCOTAComp: _from_ota_params, B.VanillaOTA: _vanilla_ota,
    B.OPCOTAComp: _opc_ota_comp, B.OPCOTAFL: _opc_ota_fl,
    B.BBFLInterior: _bbfl_interior, B.BBFLAlternative: _bbfl_alternative,
    B.ProposedDigital: _proposed_digital, B.BestChannel: _best_channel,
    B.BestChannelNorm: _best_channel_norm, B.PropFairness: _prop_fairness,
    B.UQOS: _uqos, B.QML: _qml, B.FedTOE: _fedtoe,
}


def scheme_port(agg, use_kernel: bool = True) -> SchemePort:
    """The engine's round function for a ``core.baselines`` scheme."""
    factory = _PORTS.get(type(agg))
    if factory is None:
        raise TypeError(f"{type(agg).__name__} is not a scheme of "
                        "repro_torch.core.baselines")
    return factory(agg, use_kernel)


class _Layers:
    """One run's robustness layers on the engine's device: their uniforms
    for every round (one pass a layer, widened to f64), their f64 tables,
    and the state they carry across rounds (the async buffer and the
    "stale" payloads, zeros at the start)."""

    def __init__(self, engine, seed: int, trials: int, T: int):
        dev, f64 = engine.device, torch.float64
        N, d = engine.dep.n_devices, engine.task.dim
        self.bf16 = engine.payload_dtype == "bf16"

        def uniforms(blocks, base_key):
            keys = [base_key(seed, tr) for tr in range(trials)]
            return blocks(keys, T, N, device=dev).to(f64)

        def table(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        self.part = part = engine.participation
        if part is not None:
            self.u_part = uniforms(rngstream.participation_blocks,
                                   rngstream.participate_base_key)
            self.part_probs = table(part.probs_array())
        self.asy = asy = engine.async_
        if asy is not None:
            self.u_arrival = uniforms(rngstream.arrival_blocks,
                                      rngstream.arrival_base_key)
            self.async_tables = (table(asy.rates_array()),
                                 table(asy.cdf_array()),
                                 table(asy.discounts_array()),
                                 table(asy.payload_scale_array()))
            self.a_buf = torch.zeros(trials, asy.buffer_rounds, N, d,
                                     dtype=f64, device=dev)
            self.g_alast = (torch.zeros(trials, N, d, dtype=f64, device=dev)
                            if asy.on_missing == "stale" else None)
        self.fault = fault = engine.fault
        if fault is not None:
            self.u_fault = uniforms(rngstream.fault_blocks,
                                    rngstream.fault_base_key)
            self.q_surv = table(survival_prob(fault, engine.dep.lambdas))
            self.g_stale = (torch.zeros(trials, N, d, dtype=f64, device=dev)
                            if fault.on_missing == "stale" else None)
        self.okb = self.straggler = None

    def payloads(self, g: torch.Tensor, t: int,
                 habs_t: torch.Tensor) -> torch.Tensor:
        """Round ``t``'s (trials, N, d) f64 payloads through the layers,
        in the reference's order."""
        f64 = torch.float64
        if self.bf16:
            # the payload leaves the device truncated to bf16
            g = g.to(torch.bfloat16).to(f64)
        if self.part is not None:
            chi = self.u_part[:, t] < self.part_probs
            g = g * (chi.to(f64) * self.part.scale).unsqueeze(-1)
        if self.asy is not None:
            g, ok, self.a_buf = async_fl.async_round(
                g, self.a_buf, self.u_arrival[:, t], *self.async_tables)
            if self.g_alast is not None:
                g, self.g_alast = async_fl.stale_replace(g, ok, self.g_alast)
            else:
                g = g * ok.to(f64).unsqueeze(-1)
        if self.fault is not None:
            okb, self.straggler = fault_masks(self.u_fault[:, t], habs_t,
                                              self.fault)
            self.okb = okb
            if self.fault.on_missing == "zero":
                g = g * okb.to(f64).unsqueeze(-1)
            elif self.fault.on_missing == "reweight":
                g = g * (okb.to(f64) / self.q_surv).unsqueeze(-1)
            else:
                g, self.g_stale = async_fl.stale_replace(g, okb,
                                                         self.g_stale)
        return g

    def fault_latency(self, lat_s) -> torch.Tensor:
        """The round's (trials,) seconds under faults: stretched by
        ``straggler_mult`` where a delivering straggler takes part, then
        capped at the deadline (no host sync)."""
        if not torch.is_tensor(lat_s):
            lat_s = torch.full(self.okb.shape[:-1], lat_s,
                               dtype=torch.float64, device=self.okb.device)
        slow = (self.straggler & self.okb).any(-1)
        lat_s = torch.where(slow, lat_s * self.fault.straggler_mult, lat_s)
        if self.fault.deadline_s is not None:
            lat_s = torch.clamp(lat_s, max=float(self.fault.deadline_s))
        return lat_s


def _project(w: torch.Tensor, radius: float) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    return w * torch.clamp(radius / torch.clamp(nrm, min=1e-300), max=1.0)


def check_slice(*, shard_trials: bool = False) -> None:
    """Raise ``NotImplementedError`` for what the port's engine does not
    run yet: trials laid over several cards."""
    if shard_trials:
        raise NotImplementedError(
            f"shard_trials=True is not in the port yet (one card a run); "
            f"it arrives with {_LATER}")


class _Chunked:
    """A stream's (trials, rounds, ...) draws made ``rounds`` at a time by
    ``make(t0, rounds)``, about ``_CHUNK_ENTRIES`` entries a chunk, read
    one round at a time in order."""

    def __init__(self, make, entries_per_round: int, T: int):
        self.make, self.T = make, T
        self.rounds = max(1, _CHUNK_ENTRIES // max(1, entries_per_round))
        self.t0, self.block = 0, None

    def __getitem__(self, t: int) -> torch.Tensor:
        if self.block is None or not (self.t0 <= t
                                      < self.t0 + self.block.shape[1]):
            self.t0 = t
            self.block = self.make(t, min(self.rounds, self.T - t))
        return self.block[:, t - self.t0]


class _Streams:
    """One run's per-round draws on the engine's device: |h|, the PS AWGN
    and the selection rows (replayed from NumPy's sequential generators or
    drawn from the fast threefry streams) and the mini-batch indices."""

    def __init__(self, engine, port: SchemePort, seed: int, trials: int,
                 T: int, rng: str):
        dev = engine.device
        d, N = engine.task.dim, engine.dep.n_devices
        lambdas = engine.dep.lambdas
        self.z = self.sel = self.idx = None
        if rng == "fast":
            if port.sel_stream_np is not None and port.sel_stream_fast is None:
                raise ValueError(
                    f"{port.name} consumes selection randomness but its "
                    "port has no fast-mode sampler (sel_stream_fast); use "
                    "rng='replay'")

            def keys(tag):
                return [rngstream.stream_base_key(seed, tr, tag)
                        for tr in range(trials)]

            fkeys = keys(rngstream.FADING_TAG)
            self.habs = _Chunked(lambda t0, r: fading_abs_fast(
                fkeys, r, lambdas, t0=t0, device=dev), trials * 2 * N, T)
            if port.needs_noise:
                zkeys = keys(rngstream.NOISE_TAG)
                self.z = _Chunked(lambda t0, r: rngstream.noise_blocks(
                    zkeys, t0, r, d, device=dev), trials * d, T)
            if port.sel_stream_np is not None:
                sel = port.sel_stream_fast(rngstream.round_keys(
                    keys(rngstream.SELECT_TAG), T, device=dev))
                if port.sel_plan is not None:
                    sel = torch.as_tensor(port.sel_plan(sel.cpu().numpy()),
                                          device=dev)
                self.sel = sel                            # (trials, T, S)
        else:
            self.habs = torch.as_tensor(np.abs(np.stack(
                [sample_fading_batch(lambdas, seed * 1000 + tr, T)
                 for tr in range(trials)])), device=dev)  # (trials, T, N)
            if port.needs_noise:
                self.z = torch.as_tensor(np.stack(
                    [rngstream.trial_rng(seed, tr).standard_normal((T, d))
                     for tr in range(trials)]), device=dev)
            if port.sel_stream_np is not None:
                sel = np.stack([port.sel_stream_np(seed, tr, T)
                                for tr in range(trials)])  # (trials, T, S)
                if port.sel_plan is not None:
                    sel = port.sel_plan(sel)
                self.sel = torch.as_tensor(sel, device=dev)
        if engine.batch_size is not None:
            bkeys = [rngstream.batch_base_key(seed, tr)
                     for tr in range(trials)]
            sizes, B = engine.sizes, engine.batch_size
            self.idx = _Chunked(lambda t0, r: rngstream.batch_blocks(
                bkeys, t0, r, sizes, B, mixed=engine.batch_wts is not None,
                device=dev), trials * N * max(sizes), T)

    def round(self, t: int) -> tuple:
        """(|h| (trials, N), z01 (trials, d) or None, sel (trials, S) or
        None, batch indices (trials, N, B) or None) of round ``t``."""
        def at(a):
            return None if a is None else a[:, t] if torch.is_tensor(a) \
                else a[t]
        return at(self.habs), at(self.z), at(self.sel), at(self.idx)


class FLEngine:
    """Trials-batched Monte-Carlo FL simulator on one device.

    Device data are stacked once: xs (N, n, F) f32, ys (N, n) int64,
    zero-padded to the largest device where sizes differ (which needs
    mini-batches). ``use_kernel=False`` runs the plain PyTorch versions
    of the kernels.
    """

    def __init__(self, task, dataset, deployment: Deployment, eta: float, *,
                 project_radius: Optional[float] = None,
                 batch_size: Optional[int] = None,
                 use_kernel: bool = True, shard_trials: bool = False,
                 payload_dtype: str = "f32",
                 fault=None, clients_per_round: Optional[int] = None,
                 participation: str = "uniform", participation_probs=None,
                 mode: str = "sync", async_spec=None, async_weights=None,
                 device=None):
        check_slice(shard_trials=shard_trials)
        if payload_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"payload_dtype must be 'f32' or 'bf16', got {payload_dtype!r}")
        self.payload_dtype = payload_dtype
        # each layer off normalizes to None: the round runs without it
        self.fault = fault if fault is not None and fault.enabled else None
        self.async_ = async_fl.resolve(mode, async_spec,
                                       deployment.n_devices, async_weights)
        sizes = tuple(len(d) for d in dataset.devices)
        if len(set(sizes)) == 1:
            self.batch_size = self.effective_batch_size(batch_size, sizes[0])
        elif batch_size is None:
            raise ValueError(
                "FLEngine needs a mini-batch size when device datasets "
                f"have unequal sizes (got sizes {sorted(set(sizes))}); "
                "use backend='numpy' for full-batch unequal runs")
        else:
            self.batch_size = batch_size
        self.sizes = sizes
        self.device = resolve_device(device)
        # the loss / datasize policies weigh devices by (task, dataset)
        part_weights = None
        if (clients_per_round is not None and participation_probs is None
                and participation in participation_lib.WEIGHTED_POLICIES):
            part_weights = participation_lib.policy_weights(
                participation, task, dataset, device=self.device)
        self.participation = participation_lib.resolve(
            clients_per_round, participation, participation_probs,
            n_devices=deployment.n_devices, lambdas=deployment.lambdas,
            weights=part_weights)
        self.task = task
        self.dep = deployment
        self.eta = eta
        self.project_radius = project_radius
        self.use_kernel = use_kernel
        dev = self.device
        # unequal sizes: each device zero-padded to the largest; no batch
        # row reaches the padding
        n_max, d0 = max(sizes), dataset.devices[0]
        xs = np.zeros((len(sizes), n_max) + d0.x.shape[1:], np.float32)
        ys = np.zeros((len(sizes), n_max), np.int64)
        for m, dd in enumerate(dataset.devices):
            xs[m, :len(dd)] = dd.x
            ys[m, :len(dd)] = dd.y
        self.xs = torch.as_tensor(xs, device=dev)
        self.ys = torch.as_tensor(ys, device=dev)
        if len(set(sizes)) == 1:
            self.x_all = self.xs.reshape(-1, self.xs.shape[-1])
            self.y_all = self.ys.reshape(-1)
        else:
            # the global loss over the real rows only
            self.x_all = torch.as_tensor(np.concatenate(
                [d.x for d in dataset.devices]).astype(np.float32),
                device=dev)
            self.y_all = torch.as_tensor(np.concatenate(
                [d.y for d in dataset.devices]).astype(np.int64), device=dev)
        # mixed full/mini regime: a device the batch covers runs its whole
        # dataset, each row weighted 1/n_m (0 on the clipped duplicates),
        # a mini device's rows 1/B, as f32 like the reference's
        self.batch_wts = None
        if len(set(sizes)) > 1 and self.batch_size >= min(sizes):
            wts = np.zeros((len(sizes), self.batch_size), np.float32)
            for m, n_m in enumerate(sizes):
                if n_m <= self.batch_size:
                    wts[m, :n_m] = 1.0 / n_m
                else:
                    wts[m, :] = 1.0 / self.batch_size
            self.batch_wts = torch.as_tensor(wts, device=dev)
        self.x_test = torch.as_tensor(
            np.asarray(dataset.x_test, np.float32), device=dev)
        self.y_test = torch.as_tensor(
            np.asarray(dataset.y_test, np.int64), device=dev)

    @staticmethod
    def effective_batch_size(batch_size: Optional[int],
                             n_data: int) -> Optional[int]:
        """batch_size >= |D_m| is full-batch (``DeviceDataset.batch``)."""
        return (None if batch_size is not None and batch_size >= n_data
                else batch_size)

    def _grads(self, w32: torch.Tensor, idx) -> torch.Tensor:
        """The round's (trials, N, d) f32 device gradients: full batches,
        the drawn (trials, N, B) rows, or the mixed regime's weighted
        rows."""
        if idx is None:
            return self.task.device_grads(w32, self.xs, self.ys)
        if self.batch_wts is not None:
            return self.task.device_grads_at_weighted(
                w32, self.xs, self.ys, idx, self.batch_wts)
        return self.task.device_grads_at(w32, self.xs, self.ys, idx)

    def run(self, aggregator, *, rounds: int, trials: int = 3,
            eval_every: int = 10, seed: int = 0,
            w_star: Optional[np.ndarray] = None,
            time_budget_s: Optional[float] = None,
            rng: str = "replay") -> TrainLog:
        if rng not in ("replay", "fast"):
            raise ValueError(f"rng must be 'replay' or 'fast', got {rng!r}")
        port = scheme_port(aggregator, use_kernel=self.use_kernel)
        dev = self.device
        eval_rounds = list(range(0, rounds + 1, eval_every))
        n_seg = len(eval_rounds) - 1
        T = n_seg * eval_every      # rounds past the last eval are unobserved
        d, N = self.task.dim, self.dep.n_devices

        streams = _Streams(self, port, seed, trials, T, rng)
        dkeys = [rngstream.dither_base_key(seed, tr) for tr in range(trials)]
        radius = (np.inf if self.project_radius is None
                  else float(self.project_radius))
        budget = np.inf if time_budget_s is None else float(time_budget_s)
        lat_div = self.dep.cfg.bandwidth_hz if port.is_ota else 1.0

        layers = None
        if (self.payload_dtype != "f32" or self.fault is not None
                or self.participation is not None or self.async_ is not None):
            layers = _Layers(self, seed, trials, T)

        w = self.task.init_params(device=dev).expand(trials, d).clone()
        t_wall = torch.zeros(trials, dtype=torch.float64, device=dev)
        live = torch.ones(trials, dtype=torch.bool, device=dev)
        w_eval = w.clone()
        ws, walls = [w.clone()], [t_wall.clone()]
        for t in range(T):
            # a trial stops on the first round whose preceding cumulative
            # wall-clock reached the budget; its state freezes from there
            active = t_wall < budget
            habs_t, z_t, sel_t, idx_t = streams.round(t)
            g = self._grads(w.to(torch.float32), idx_t).to(torch.float64)
            if layers is not None:
                g = layers.payloads(g, t, habs_t)
            u = (rngstream.dither_blocks(dkeys, t, N, d, device=dev)
                 if port.needs_dither else None)
            ghat, lat = port.round_fn(g, habs_t, z_t, u, sel_t, t)
            w = torch.where(active[:, None], _project(w - self.eta * ghat,
                                                      radius), w)
            # division (not a reciprocal multiply), as the reference
            if layers is not None and layers.fault is not None:
                t_wall = torch.where(
                    active, t_wall + layers.fault_latency(lat / lat_div),
                    t_wall)
            else:
                t_wall = torch.where(active, t_wall + lat / lat_div, t_wall)
            live = active
            if (t + 1) % eval_every == 0:
                # the eval at a segment's end is written iff its last round
                # ran; otherwise the slot keeps the last written eval
                w_eval = torch.where(live[:, None], w, w_eval)
                ws.append(w_eval.clone())
                walls.append(t_wall.clone())
        W = torch.stack(ws, dim=1)                            # (trials, E, d)
        losses, accs = self._evaluate(W)
        opt_err = None
        if w_star is not None:
            w_np = W.cpu().numpy()
            opt_err = np.sum((w_np - np.asarray(w_star)) ** 2, axis=-1)
        return TrainLog(scheme=port.name,
                        rounds=np.asarray(eval_rounds, dtype=np.int64),
                        wall_time_s=torch.stack(walls, 1).mean(0).cpu().numpy(),
                        global_loss=losses, accuracy=accs,
                        opt_error=opt_err)

    def _evaluate(self, ws: torch.Tensor):
        """Global loss + test accuracy of every eval-point model, in the
        reference's float32 eval precision."""
        trials, E, d = ws.shape
        wf = ws.reshape(trials * E, d).to(torch.float32)
        losses = self.task.loss(wf, self.x_all, self.y_all)
        accs = self.task.accuracy(wf, self.x_test, self.y_test)
        return (losses.reshape(trials, E).to(torch.float64).cpu().numpy(),
                accs.reshape(trials, E).to(torch.float64).cpu().numpy())
