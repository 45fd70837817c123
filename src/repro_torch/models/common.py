"""Shared model primitives: the config, the parameter initialiser, the
RMS norm, RoPE, SwiGLU and the activations (counterparts of
``repro.models.common``).

Parameters live in ``nn.Module``s under the reference's names, so a
reference leaf ``groups/b0/mamba/in_proj`` (layer axis first) is the
port's ``layers.<i>.mamba.in_proj`` (``repro_torch.interop``). They are
drawn from one explicit ``torch.Generator`` on the target device, with the
reference's shapes and scales; the draws themselves differ from JAX's, so
tests carry the reference's weights across instead. Each records the
logical axes the reference's ``ParamBuilder.param`` gives it; with a
placement (``launch.sharding.Placement``) a rank holds only its block of
each, drawn whole with the one-card generator sequence and then cut.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn


# --------------------------------------------------------------- config

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    # layer pattern, cycled over depth: entries in {"global","local","rglru","mamba"}
    layer_pattern: tuple = ("global",)
    window_size: int = 4096
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 -> d_model // 16
    # RG-LRU (hybrid)
    lru_width: int = 0              # 0 -> d_model
    conv1d_width: int = 4
    # encoder-decoder (audio)
    encoder_layers: int = 0
    encoder_positions: int = 0      # stub frame embeddings length
    max_target_positions: int = 0   # decoder context limit (0 = unlimited)
    # VLM
    vision_prefix: int = 0          # stub patch embeddings prepended
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # citation / provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank if self.ssm_dt_rank else max(1, self.d_model // 16)

    @property
    def lru_dim(self) -> int:
        return self.lru_width if self.lru_width else self.d_model

    def kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0

    @property
    def supports_long_decode(self) -> bool:
        """True iff decode cost is sub-quadratic (window / recurrent)."""
        return all(k in ("local", "rglru", "mamba") for k in self.layer_pattern)

    def scaled_down(self) -> "ModelConfig":
        """Reduced variant for CPU smoke tests (<=2 groups, d<=256, <=4 experts)."""
        pat = self.layer_pattern
        n_layers = max(len(pat), 2)
        d = min(self.d_model, 128)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        hd = d // heads
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d, n_heads=heads, n_kv_heads=kv,
            head_dim=hd, d_ff=min(self.d_ff, 256) or 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            n_experts_per_tok=min(self.n_experts_per_tok, 2),
            ssm_state=min(self.ssm_state, 8), ssm_dt_rank=8 if self.ssm_state else 0,
            lru_width=min(self.lru_dim, d) if self.lru_width else 0,
            window_size=min(self.window_size, 64),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_positions=min(self.encoder_positions, 32),
            vision_prefix=min(self.vision_prefix, 8),
            dtype=torch.float32, name=self.name + "-smoke")


# ------------------------------------------------------------ params

class ParamInit:
    """Draws parameters as ``repro.models.common.ParamBuilder.param`` does:
    ``normal`` at 1/sqrt(shape[0]) unless a scale is given (drawn in f32,
    then cast), ``zeros``, ``ones``, ``ssm_a`` = log(1..n) per channel
    computed in the parameter dtype, and the RG-LRU's ``lru_a`` =
    log(exp(-8 log u) - 1) for u uniform in [0.9, 0.999) (drawn in f32,
    cast, then computed in the parameter dtype: in bf16 a u that rounds to
    1 gives -inf, as in the reference, and a = 1 on that channel).
    ``generator=None`` leaves every parameter uninitialised
    (``torch.empty``), for weights loaded after.

    ``placement`` (``launch.sharding.Placement``, None on one card) cuts
    each parameter by its logical ``axes``: the whole leaf is drawn, so
    the generator runs through the one-card sequence, and only this
    rank's block is kept (without a generator only the block is
    allocated).
    """

    def __init__(self, dtype, device, generator: Optional[torch.Generator],
                 placement=None):
        self.dtype = dtype
        self.device = device
        self.generator = generator
        self.placement = placement

    def __call__(self, shape: tuple, init: str = "normal",
                 scale: Optional[float] = None,
                 axes: Optional[tuple] = None) -> torch.Tensor:
        if self.placement is None or axes is None:
            return self._draw(shape, init, scale)
        if self.generator is None:
            return self._draw(self.placement.local_shape(shape, axes), init,
                              scale)
        whole = self._draw(shape, init, scale)
        block = self.placement.block(whole, axes)
        return whole if block.shape == whole.shape else block.clone()

    def _draw(self, shape: tuple, init: str,
              scale: Optional[float]) -> torch.Tensor:
        kw = dict(dtype=self.dtype, device=self.device)
        if self.generator is None:
            return torch.empty(shape, **kw)
        if init == "normal":
            s = float(scale if scale is not None else 1.0 / math.sqrt(shape[0]))
            v = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            return (v * s).to(self.dtype)
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        if init == "ssm_a":
            n = shape[-1]
            return torch.log(torch.arange(1, n + 1, **kw).repeat(shape[0], 1))
        if init == "lru_a":
            u = torch.rand(shape, generator=self.generator,
                           dtype=torch.float32, device=self.device)
            u = (u * (0.999 - 0.9) + 0.9).to(self.dtype)
            return torch.log(torch.exp(-torch.log(u) * 8.0) - 1.0)
        raise ValueError(init)


class ParamModule(nn.Module):
    """A module whose leaves are parameters named as the reference's,
    readable as ``p["name"]`` like the reference's dicts. They train;
    serving runs under ``torch.no_grad``. ``leaf_meta[name]`` keeps each
    one's logical axes and its whole shape (which a rank holding a block
    does not see)."""

    def param(self, draw: ParamInit, name: str, shape: tuple, axes: tuple,
              **kw) -> None:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} and axes {axes}")
        if "leaf_meta" not in self.__dict__:
            self.leaf_meta = {}
        self.leaf_meta[name] = (tuple(axes), tuple(shape))
        self.register_parameter(name, nn.Parameter(draw(shape, axes=axes,
                                                        **kw)))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


# ------------------------------------------------------------ functional

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 mean of squares and rsqrt, cast back before the weight multiply
    (``repro.models.common.rms_norm``)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), as ``jax.nn.silu`` writes it."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, as ``jax.nn.gelu``'s default (``approximate=True``);
    torch's default is the erf form."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """logaddexp(x, 0), as ``jax.nn.softplus`` (torch's ``F.softplus``
    switches to x above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S). Angles and
    the rotation in f32 (x widens), cast back to x's dtype."""
    d_half = x.shape[-1] // 2
    exps = -torch.arange(0, d_half, dtype=torch.float32,
                         device=x.device) / d_half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = positions[..., :, None, None].float() * freq     # (..., S, 1, Dh)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d_half], x[..., d_half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    h = silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
