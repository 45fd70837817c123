"""Counter-based randomness streams, bit-equal to ``repro.core.rngstream``.

The reference draws quantization dither from JAX's threefry PRNG: the
(N, d) uniform block of round ``t`` in trial ``trial`` is a pure function
of ``(seed, trial, t)``. This module reimplements threefry2x32 and the
three ``jax.random`` operations the dither stream uses, so the port
regenerates the same bits without JAX:

  * ``prng_key(s)    = (0, s)`` for a 32-bit seed;
  * ``fold_in(k, t)  = threefry2x32(k, x0=[0], x1=[t])``;
  * ``uniform(k, shape)``: counters ``i = arange(prod(shape))`` split as
    ``(hi32(i), lo32(i))``, ``bits = y0 ^ y1``, and
    ``f32 = bitcast((bits >> 9) | 0x3F800000) - 1`` — JAX's layout under
    ``jax_threefry_partitionable=True`` (the default since JAX 0.5).

Words are 32-bit values held in int64 lanes and masked after every add and
shift: CPU PyTorch has no uint32 add or shift. The same code runs on
Python ints (keys, computed on the host) and on int64 tensors (counters,
on the tensor's device).

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


def _uniform_f32(k0, k1, n: int, device) -> torch.Tensor:
    """(..., n) f32 uniforms in [0, 1) from the first n counters."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000          # < 2^31: fits int32
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: tuple[int, int], shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``, bit for bit."""
    shape = tuple(int(s) for s in shape)
    return _uniform_f32(key[0], key[1], int(np.prod(shape)),
                        device).reshape(shape)


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
