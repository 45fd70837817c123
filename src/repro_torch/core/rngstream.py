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

Mini-batch indices (tag 29) are ``jax.random.choice(replace=False)``: a
prefix of ``permutation``, JAX's sort-based shuffle (``ceil(3 ln n /
ln(2^32 - 1))`` rounds, each a split and a stable sort by fresh 32-bit
bits). Device m's batch in round t hashes ``fold_in(fold_in(key, t),
m)``; ``batch_blocks`` makes a (trials, rounds, N, B) block in one pass.
int64 lanes holding uint32 values sort in unsigned order, as JAX's.

``rng="fast"`` draws the PS AWGN (tag 41, f32 normals widened), the
fading (tag 43, f64 normals) and the selection rows (tag 47) from
``(key, t)`` too. f64 uniforms take the 52 mantissa bits
``(y0 << 20) | (y1 >> 12)`` of JAX's 64-bit ``(y0 << 32) | y1`` (bit-equal),
f64 normals XLA's f64 log1p and erfinv polynomial (within 3 ulp). In
replay mode the PS AWGN, the fading and the selection draws stay on
NumPy's sequential generators (``trial_rng``, ``replay_rounds``,
``channel.sample_fading``), exactly as the reference's replay mode draws
them.

Every sampler takes its key as a pair of Python ints or of int64 tensors
of shape (..., 1); tensor keys add their leading dimensions to the
draw's shape, so one call makes the draws of many (trial, round, device)
keys.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

#: Stream tag folded into the dither key (the reference's DITHER_TAG).
DITHER_TAG = 17

#: The mini-batch index stream (the reference's BATCH_TAG).
BATCH_TAG = 29

#: ``rng="fast"`` streams: PS AWGN, Rayleigh fading, selection draws.
NOISE_TAG = 41
FADING_TAG = 43
SELECT_TAG = 47

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


def _lead(k0) -> tuple:
    """The leading dimensions a key adds to its draw: () for int keys."""
    return tuple(k0.shape[:-1]) if torch.is_tensor(k0) else ()


def uniform(key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``, bit for bit."""
    shape = tuple(int(s) for s in shape)
    return _uniform_f32(key[0], key[1], int(np.prod(shape)),
                        device).reshape(_lead(key[0]) + shape)


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


def normal(key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: the uniforms mapped onto
    [nextafter(-1, 0), 1) (bit-equal), then ``sqrt(2) * erfinv(u)`` with
    XLA's polynomial, chunk by chunk (within 3 ulp: XLA's log1p and FMA
    contraction differ from torch's)."""
    shape = tuple(int(s) for s in shape)
    return _uniform_f32(key[0], key[1], int(np.prod(shape)), device,
                        _normal_from_uniform).reshape(_lead(key[0]) + shape)


def _counters(n: int, device) -> tuple:
    """JAX's (hi, lo) counter words of the flat indices 0..n-1."""
    i = torch.arange(int(n), dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def random_bits32(key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: ``y0 ^ y1``, the words
    :func:`uniform` maps, as uint32 values in int64 lanes."""
    shape = tuple(int(s) for s in shape)
    y0, y1 = threefry2x32(key[0], key[1],
                          *_counters(np.prod(shape), device))
    return (y0 ^ y1).reshape(_lead(key[0]) + shape)


def random_bits64(key, shape, *, device="cpu") -> tuple:
    """``jax.random.bits(key, shape, uint64) = (y0 << 32) | y1`` as its
    (hi, lo) words in int64 lanes (the whole word overflows an int64)."""
    shape = tuple(int(s) for s in shape)
    y0, y1 = threefry2x32(key[0], key[1],
                          *_counters(np.prod(shape), device))
    lead = _lead(key[0])
    return y0.reshape(lead + shape), y1.reshape(lead + shape)


def uniform_f64(key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float64)``, bit for bit: the top 52
    of the 64 bits, ``(y0 << 20) | (y1 >> 12)``, as the mantissa of a
    number in [1, 2), minus 1."""
    hi, lo = random_bits64(key, shape, device=device)
    bits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
    return bits.view(torch.float64) - 1.0


#: ``np.nextafter(-1, 0)`` in f64 and the span 1 - lo, which rounds to 2
_NORMAL_LO64 = float(np.nextafter(-1.0, 0.0))
_NORMAL_SPAN64 = float(np.float64(1.0) - np.float64(_NORMAL_LO64))
_SQRT2_F64 = float(np.sqrt(2))

# XLA's f64 erfinv (Giles' double-precision approximation, the chlo
# lowering ``jax.random.normal`` takes): polynomials in w - 3.125 for
# w = -log1p(-x^2) < 6.25, in sqrt(w) - 3.25 for w < 16, else sqrt(w) - 5.
_ERFINV64_W_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_W_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_W_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


# XLA's f64 log1p (Cephes): for |x| < sqrt(2) - 1 the rational
# x - x^2/2 + x^3 P(x)/Q(x), else log(1 + x). glibc's log1p is up to 128
# ulp from it on (-1, 0], and erfinv's branches subtract 3.125 or 3.25
# from w, which turns that into far more.
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log1p_f64(x: torch.Tensor) -> torch.Tensor:
    """log1p of f64 x as XLA's CPU lowering computes it (within 1 ulp)."""
    def poly(c):
        p = torch.full_like(x, c[0])
        for ci in c[1:]:
            p = p * x + ci
        return p

    x2 = x * x
    small = x + (-0.5 * x2 + x * x2 * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def erfinv_f64(x: torch.Tensor) -> torch.Tensor:
    """erfinv of f64 x in (-1, 1) as XLA computes it: the w < 6.25 branch
    runs all 23 Horner steps, the w < 16 one its first 19 and the last
    its first 17 (erfinv(+-1) = +-inf), on XLA's log1p. Each entry's
    coefficients and shift are gathered from one table by its branch."""
    w = -log1p_f64(-x * x)
    lt625, lt16 = w < 6.25, w < 16.0
    branch = (~lt625).to(torch.int64) + (~lt16).to(torch.int64)
    table = torch.zeros(3, 23, dtype=torch.float64, device=x.device)
    for b, c in enumerate((_ERFINV64_W_LT625, _ERFINV64_W_LT16,
                           _ERFINV64_W_GE16)):
        table[b, :len(c)] = torch.tensor(c, dtype=torch.float64)
    shift = torch.tensor((3.125, 3.25, 5.0), dtype=torch.float64,
                         device=x.device)[branch]
    w = torch.where(lt625, w, torch.sqrt(w)) - shift
    coef = table.T[:, branch]                       # (23,) + x.shape
    p = coef[0]
    for i in range(1, 17):
        p = coef[i] + p * w
    for i in range(17, 19):
        p = torch.where(lt16, coef[i] + p * w, p)
    for i in range(19, 23):
        p = torch.where(lt625, coef[i] + p * w, p)
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal_f64(key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float64)``: the f64 uniforms
    mapped onto [nextafter(-1, 0), 1) (bit-equal: the span rounds to 2,
    so the product is exact), then ``sqrt(2) * erfinv(u)`` with XLA's f64
    polynomial (within a few ulps: ``tests/test_torch_rng_fast.py``
    states the gap)."""
    u = uniform_f64(key, shape, device=device)
    u = torch.clamp_min(u * _NORMAL_SPAN64 + _NORMAL_LO64, _NORMAL_LO64)
    return erfinv_f64(u) * _SQRT2_F64


def shuffle_rounds(n: int) -> int:
    """The sorts JAX's ``_shuffle`` makes for n entries: ceil(3 ln n /
    ln(2^32 - 1)), 1 up to n = 1625, 2 from 1626."""
    return int(np.ceil(3 * np.log(max(1, int(n)))
                       / np.log(np.iinfo(np.uint32).max)))


def permutation(key, n: int, *, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64): each round splits
    ``key, sub = split(key)`` and sorts the entries stably by
    ``random_bits32(sub, (n,))``. A batch of keys (..., 1) shuffles
    (..., n) rows, each by its own key."""
    k0, k1 = key
    x = torch.arange(int(n), dtype=torch.int64, device=device)
    x = x.expand(_lead(k0) + (int(n),))
    for _ in range(shuffle_rounds(n)):
        (k0, k1), sub = split((k0, k1), 2)
        order = torch.sort(random_bits32(sub, (n,), device=device), dim=-1,
                           stable=True).indices
        x = x.gather(-1, order)
    return x


def choice_without_replacement(key, n: int, k: int, *,
                               device="cpu") -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first k of
    a whole permutation of n (int64)."""
    return permutation(key, n, device=device)[..., :int(k)]


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


def round_keys(keys, rounds: int, *, t0: int = 0, device="cpu") -> tuple:
    """The (K, rounds, 1) key pair ``fold_in(key, t)`` of rounds t0 ..
    t0 + rounds - 1 for K trial keys, folded on ``device``."""
    k0 = torch.tensor([k[0] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    k1 = torch.tensor([k[1] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    t = torch.arange(int(t0), int(t0) + int(rounds), dtype=torch.int64,
                     device=device)[None]
    f0, f1 = threefry2x32(k0, k1, 0, t)                   # (K, rounds)
    return f0[..., None], f1[..., None]


def round_blocks(keys, rounds: int, shape, *, device="cpu") -> torch.Tensor:
    """(K, rounds) + shape f32: the block ``uniform(fold_in(key, t),
    shape)`` of every round t < ``rounds`` for K trial keys, in one pass
    on ``device`` (the round keys are folded there too). The streams are
    counter-based, so this is the per-round draw's bits; the engine makes
    a layer's uniforms for a whole run with it."""
    return uniform(round_keys(keys, rounds, device=device), shape,
                   device=device)


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


def noise_block(key, t: int, d: int, *, device="cpu") -> torch.Tensor:
    """(d,) f64 PS AWGN of round ``t`` in fast mode (``key`` from
    ``stream_base_key(seed, trial, NOISE_TAG)``): f32 normals widened."""
    return normal(fold_in(key, t), (d,), device=device).to(torch.float64)


def noise_blocks(keys, t0: int, rounds: int, d: int, *,
                 device="cpu") -> torch.Tensor:
    """(K, rounds, d): :func:`noise_block` of rounds t0 .. t0 + rounds - 1
    for K trial keys in one pass."""
    return normal(round_keys(keys, rounds, t0=t0, device=device), (d,),
                  device=device).to(torch.float64)


def batch_base_key(seed: int, trial: int) -> tuple[int, int]:
    """Per-trial base key of the mini-batch index stream."""
    return stream_base_key(seed, trial, BATCH_TAG)


def batch_indices(key, t: int, m: int, n_data: int, batch_size: int, *,
                  device="cpu") -> torch.Tensor:
    """(B,) int64 sample of range(n_data) without replacement for device
    ``m`` in round ``t``: ``choice(fold_in(fold_in(key, t), m), n_data,
    (B,), replace=False)``."""
    return choice_without_replacement(fold_in(fold_in(key, t), m), n_data,
                                      batch_size, device=device)


def batch_blocks(keys, t0: int, rounds: int, sizes, batch_size: int, *,
                 mixed: bool = False, device="cpu") -> torch.Tensor:
    """(K, rounds, N, B) int64 batch indices of rounds t0 .. t0 + rounds -
    1 for K trial keys and N devices of ``sizes`` samples, in one pass:
    row m of round t is :func:`batch_indices` of device m with its own
    size (the folds: round first, then device). With ``mixed``, a device
    of at most B samples draws nothing and gathers ``min(arange(B),
    n_m - 1)``, its whole dataset and then its last row again (the
    engine weighs those duplicates 0)."""
    B = int(batch_size)
    f0, f1 = round_keys(keys, rounds, t0=t0, device=device)
    m = torch.arange(len(sizes), dtype=torch.int64, device=device)
    g0, g1 = threefry2x32(f0, f1, 0, m)                   # (K, rounds, N)
    out = torch.empty(g0.shape + (B,), dtype=torch.int64, device=device)
    for n_m in sorted(set(int(n) for n in sizes)):
        rows = [i for i, n in enumerate(sizes) if int(n) == n_m]
        if mixed and n_m <= B:
            out[..., rows, :] = torch.clamp(
                torch.arange(B, dtype=torch.int64, device=device),
                max=n_m - 1)
        elif n_m < B:
            raise ValueError(f"cannot draw {B} of {n_m} samples without "
                             "replacement")
        else:
            out[..., rows, :] = choice_without_replacement(
                (g0[..., rows, None], g1[..., rows, None]), n_m, B,
                device=device)
    return out


def batch_block(key, t: int, n_devices: int, n_data: int, batch_size: int,
                *, device="cpu") -> torch.Tensor:
    """(N, B) int64 batch indices of round ``t``, devices of equal size."""
    return batch_blocks([key], t, 1, (n_data,) * n_devices, batch_size,
                        device=device)[0, 0]


def batch_block_ragged(key, t: int, sizes, batch_size: int, *,
                       device="cpu") -> torch.Tensor:
    """(N, B) int64 batch indices of round ``t``, device m drawing from
    its own ``sizes[m]`` samples (every size at least B)."""
    return batch_blocks([key], t, 1, sizes, batch_size, device=device)[0, 0]


def batch_block_mixed(key, t: int, sizes, batch_size: int, *,
                      device="cpu") -> torch.Tensor:
    """(N, B) int64 batch indices of round ``t`` in the mixed full/mini
    regime: devices larger than B draw as :func:`batch_block_ragged`, the
    others gather their whole dataset (see :func:`batch_blocks`)."""
    return batch_blocks([key], t, 1, sizes, batch_size, mixed=True,
                        device=device)[0, 0]


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
