"""Counter-based randomness streams, bit-equal to ``repro.core.rngstream``.

The reference draws quantization dither from JAX's threefry PRNG: the
(N, d) uniform block of round ``t`` in trial ``trial`` is a pure function
of ``(seed, trial, t)``. This module reimplements threefry2x32 and the
``jax.random`` operations the dither stream and the FL-LM collective use,
so the port regenerates the same bits without JAX:

  * ``prng_key(s)    = (0, s)`` for a 32-bit seed (also ``jax.random.key``);
  * ``fold_in(k, t)  = threefry2x32(k, x0=[0], x1=[t])``;
  * ``split(k, n)[i] = threefry2x32(k, x0=[0], x1=[i])``;
  * ``uniform(k, shape)``: counters ``i = arange(prod(shape))`` split as
    ``(hi32(i), lo32(i))``, ``bits = y0 ^ y1``, and
    ``f32 = bitcast((bits >> 9) | 0x3F800000) - 1`` — JAX's layout under
    ``jax_threefry_partitionable=True`` (the default since JAX 0.5). The
    counters are drawn ``UNIFORM_CHUNK`` at a time: each is its flat index,
    so chunking changes no bit and bounds the int64 temporaries;
  * ``normal(k, shape)``: those uniforms mapped onto
    [nextafter(-1, 0), 1) and ``sqrt(2) * erfinv(u)`` in f32, with XLA's
    erfinv polynomial (torch's own ``erfinv`` is up to 91 ulp from it).
    The uniforms are bit-equal, the normals within a few ulps
    (``tests/test_torch_collectives.py`` states the gap).

Words are 32-bit values held in int64 lanes and masked after every add and
shift: CPU PyTorch has no uint32 add or shift. The same code runs on
Python ints (keys, computed on the host) and on int64 tensors (counters,
on the tensor's device).

The engine layers' streams (fault, participation, async arrival) are
counter-based like the dither: one small uniform block a round, tagged
53, 59 and 61, which ``round_blocks`` makes for every round of a run in
one pass.

The PS AWGN, the fading and the selection draws of the digital baselines
stay on NumPy's sequential generators (``trial_rng``, ``replay_rounds``,
``channel.sample_fading``), exactly as the reference's replay mode draws
them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

#: Stream tag folded into the dither key (the reference's DITHER_TAG).
DITHER_TAG = 17

#: The engine layers' streams (the reference's tags): dropout / erasure /
#: straggler uniforms, (3, N) a round; client-sampling uniforms, (N,) a
#: round; async delivery / staleness uniforms, (2, N) a round.
FAULT_TAG = 53
PARTICIPATE_TAG = 59
ARRIVAL_TAG = 61

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under key
    (k0, k1). Arguments are Python ints or int64 tensors holding 32-bit
    words (broadcastable); returns the output pair in the same form."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey`` of a 32-bit seed, as a pair of ints."""
    return 0, int(seed) & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` for a non-negative 32-bit ``data``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def split(key: tuple[int, int], n: int) -> list[tuple[int, int]]:
    """``jax.random.split(key, n)`` (partitionable layout): key i hashes
    the counter pair (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(int(n))]


#: Counters hashed per pass of :func:`uniform` (each pass holds about ten
#: int64 temporaries of this length: 1.3 GB at 2^24).
UNIFORM_CHUNK = 1 << 24


def _uniform_chunks(k0, k1, n: int, device):
    """(start, (..., c) f32 uniforms in [0, 1)) for the counters
    [start, start + c), ``UNIFORM_CHUNK`` at a time; k0, k1 are ints or
    int64 tensors of shape (..., 1)."""
    for c0 in range(0, n, UNIFORM_CHUNK):
        i = torch.arange(c0, min(n, c0 + UNIFORM_CHUNK), dtype=torch.int64,
                         device=device)
        y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
        bits = ((y0 ^ y1) >> 9) | 0x3F800000      # < 2^31: fits int32
        yield c0, bits.to(torch.int32).view(torch.float32) - 1.0


def _uniform_f32(k0, k1, n: int, device, transform=None) -> torch.Tensor:
    """(..., n) f32 uniforms from the first n counters, each chunk passed
    through ``transform`` if given."""
    lead = tuple(k0.shape[:-1]) if torch.is_tensor(k0) else ()
    out = torch.empty(lead + (n,), dtype=torch.float32, device=device)
    for c0, u in _uniform_chunks(k0, k1, n, device):
        out[..., c0:c0 + u.shape[-1]] = u if transform is None else transform(u)
    return out


def uniform(key: tuple[int, int], shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``, bit for bit."""
    shape = tuple(int(s) for s in shape)
    return _uniform_f32(key[0], key[1], int(np.prod(shape)),
                        device).reshape(shape)


#: ``np.nextafter(-1, 0)`` in f32, the lower end of ``jax.random.normal``'s
#: uniforms.
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))

# XLA's f32 erfinv (Giles' single-precision approximation), the one
# ``jax.random.normal`` lowers to: a degree-8 polynomial in w - 2.5 for
# w = -log1p(-x^2) < 5, else in sqrt(w) - 3.
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erfinv of f32 x in (-1, 1) as XLA computes it (Horner steps with the
    multiply and add rounded apart; erfinv(+-1) = +-f32 max * 1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    lo, hi = torch.tensor((_ERFINV_W_LT5, _ERFINV_W_GE5), device=x.device)
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_W_LT5)):
        p = torch.where(lt, lo[i], hi[i]) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def _normal_from_uniform(u: torch.Tensor) -> torch.Tensor:
    # 1 - lo rounds to 2 in f32, so u * 2 is exact before the add
    u = torch.clamp_min(u * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return erfinv_f32(u) * _SQRT2_F32


def normal(key: tuple[int, int], shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: the uniforms mapped onto
    [nextafter(-1, 0), 1) (bit-equal), then ``sqrt(2) * erfinv(u)`` with
    XLA's polynomial, chunk by chunk (within 3 ulp: XLA's log1p and FMA
    contraction differ from torch's)."""
    shape = tuple(int(s) for s in shape)
    return _uniform_f32(key[0], key[1], int(np.prod(shape)), device,
                        _normal_from_uniform).reshape(shape)


def stream_base_key(seed: int, trial: int, tag: int) -> tuple[int, int]:
    """Per-(trial, stream) base key: fold (seed, trial, tag)."""
    return fold_in(fold_in(prng_key(int(seed) & _M32), trial), tag)


def dither_base_key(seed: int, trial: int) -> tuple[int, int]:
    """Per-trial base key of the dither stream."""
    return stream_base_key(seed, trial, DITHER_TAG)


def dither_block(key: tuple[int, int], t: int, n: int, d: int,
                 *, device="cpu") -> torch.Tensor:
    """(n, d) f32 dither uniforms of round ``t`` (``key`` from
    :func:`dither_base_key`)."""
    return uniform(fold_in(key, t), (n, d), device=device)


def dither_blocks(keys, t: int, n: int, d: int, *,
                  device="cpu") -> torch.Tensor:
    """(K, n, d): :func:`dither_block` of round ``t`` for K trial keys in
    one pass (trials are the leading dimension of the engine's state)."""
    folded = [fold_in(k, t) for k in keys]
    k0 = torch.tensor([k[0] for k in folded], dtype=torch.int64,
                      device=device)[:, None]
    k1 = torch.tensor([k[1] for k in folded], dtype=torch.int64,
                      device=device)[:, None]
    return _uniform_f32(k0, k1, n * d, device).reshape(len(folded), n, d)


def fault_base_key(seed: int, trial: int) -> tuple[int, int]:
    """Per-trial base key of the fault-injection stream."""
    return stream_base_key(seed, trial, FAULT_TAG)


def participate_base_key(seed: int, trial: int) -> tuple[int, int]:
    """Per-trial base key of the client-participation stream."""
    return stream_base_key(seed, trial, PARTICIPATE_TAG)


def arrival_base_key(seed: int, trial: int) -> tuple[int, int]:
    """Per-trial base key of the async-arrival stream."""
    return stream_base_key(seed, trial, ARRIVAL_TAG)


def fault_block(key, t: int, n: int, *, device="cpu") -> torch.Tensor:
    """(3, n) f32 fault uniforms of round ``t``: rows drive dropouts,
    erasures and stragglers (``core.faults.fault_masks``)."""
    return uniform(fold_in(key, t), (3, n), device=device)


def participation_block(key, t: int, n: int, *, device="cpu") -> torch.Tensor:
    """(n,) f32 participation uniforms of round ``t``: device m is in the
    round's cohort iff ``block[m] < pi_m``."""
    return uniform(fold_in(key, t), (n,), device=device)


def arrival_block(key, t: int, n: int, *, device="cpu") -> torch.Tensor:
    """(2, n) f32 arrival uniforms of round ``t``: row 0 the delivery
    event, row 1 the staleness draw (``core.async_fl.async_round``)."""
    return uniform(fold_in(key, t), (2, n), device=device)


def round_blocks(keys, rounds: int, shape, *, device="cpu") -> torch.Tensor:
    """(K, rounds) + shape f32: the block ``uniform(fold_in(key, t),
    shape)`` of every round t < ``rounds`` for K trial keys, in one pass
    on ``device`` (the round keys are folded there too). The streams are
    counter-based, so this is the per-round draw's bits; the engine makes
    a layer's uniforms for a whole run with it."""
    shape = tuple(int(s) for s in shape)
    k0 = torch.tensor([k[0] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    k1 = torch.tensor([k[1] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    t = torch.arange(int(rounds), dtype=torch.int64, device=device)[None]
    f0, f1 = threefry2x32(k0, k1, 0, t)                   # (K, rounds)
    n = int(np.prod(shape))
    return _uniform_f32(f0[..., None], f1[..., None], n, device).reshape(
        (len(keys), int(rounds)) + shape)


def fault_blocks(keys, rounds: int, n: int, *, device="cpu") -> torch.Tensor:
    """(K, rounds, 3, n): :func:`fault_block` of every round."""
    return round_blocks(keys, rounds, (3, n), device=device)


def participation_blocks(keys, rounds: int, n: int, *,
                         device="cpu") -> torch.Tensor:
    """(K, rounds, n): :func:`participation_block` of every round."""
    return round_blocks(keys, rounds, (n,), device=device)


def arrival_blocks(keys, rounds: int, n: int, *,
                   device="cpu") -> torch.Tensor:
    """(K, rounds, 2, n): :func:`arrival_block` of every round."""
    return round_blocks(keys, rounds, (2, n), device=device)


def trial_rng(seed: int, trial: int) -> np.random.Generator:
    """The sequential per-trial generator (PS AWGN in replay mode)."""
    return np.random.default_rng((seed, trial, 17))


def replay_rounds(seed: int, trial: int, rounds: int,
                  draw_fn: Callable[[np.random.Generator], np.ndarray]
                  ) -> np.ndarray:
    """Replay ``rounds`` per-round draws of the sequential trial generator.

    ``draw_fn(rng)`` consumes exactly what one round of the scheme draws
    from ``trial_rng(seed, trial)`` (its selection), in order, and returns
    it as a flat f64 row. Returns the (rounds, S) stack the engine copies
    to the device once per run.
    """
    rng = trial_rng(seed, trial)
    rows = [np.asarray(draw_fn(rng), dtype=np.float64).ravel()
            for _ in range(rounds)]
    if not rows:
        return np.zeros((0, 1))
    return np.stack(rows)
