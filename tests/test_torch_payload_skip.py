"""The packed weighted sum may skip the devices that add nothing.

``csrc/payload.cu``'s ``packed_weighted_sum`` leaves out of its device
loop every device whose every term ``w * v`` is +-0: a row that does not
quantize (m = 0 or L <= 0, so v = 0) under a finite weight, and a device
out of the round (w = 0) whose values -m + safe * q are all finite. The
kernel is held bit-equal to ``ref.packed_weighted_sum_ref`` on the card;
these tests show, on the plain version, that the skip changes no bit:
the sum over the kept devices alone equals the sum over all of them,
compared as integers so that -0.0 and +0.0 differ. The accumulator starts
at +0.0 and is only ever added to under round-to-nearest, so it is never
-0.0, and adding +-0.0 leaves it as it was.

In f64 the kernel also turns half the codes q into doubles without a
conversion instruction, from the bits of 2^52 + q less 2^52; the last
test checks that identity for every 16-bit code.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as plain

DTYPES = {"f64": (torch.float64, torch.int64),
          "f32": (torch.float32, torch.int32)}
D = 3001                        # not a multiple of a word row's entries
N_DEV = 12


def _silent(scal: torch.Tensor, code_bits: int) -> torch.Tensor:
    """The kernel's rule (``stage_devices``): (T, N) True where device i of
    trial t adds +-0 to every entry."""
    m, levels, w = scal.unbind(-1)
    valid = (levels > 0) & (m > 0)
    safe = torch.where(valid, 2.0 * m / torch.where(levels > 0, levels, 1.0),
                       1.0)
    top = safe * float((1 << code_bits) - 1)
    return torch.where(valid, (w == 0) & torch.isfinite(top),
                       torch.isfinite(w))


def _inputs(dt: str, code_bits: int, nonfinite: bool, seed: int = 0):
    """Words and (m, levels, w) of 3 trials x N_DEV devices, made by numpy
    from a seed. Trial 0: rows that do not quantize (m = 0, levels 0) under
    weights of both signs, devices out of the round. Trial 1: every device
    silent. Trial 2: every device live but one. With ``nonfinite``, trial 0
    also has a non-finite weight on a row that does not quantize, and a
    device out of the round whose m is so large that safe * q overflows:
    both must be kept."""
    tdt = DTYPES[dt][0]
    rng = np.random.default_rng([code_bits, int(nonfinite), seed])
    T = 3
    g = rng.normal(size=(T, N_DEV, D)) * rng.uniform(0.01, 5.0,
                                                      size=(T, N_DEV, 1))
    levels = (2.0 ** rng.integers(1, code_bits + 1, size=(T, N_DEV))) - 1.0
    w = rng.uniform(0.1, 2.0, size=(T, N_DEV))
    g[0, 1] = 0.0                              # m = 0
    levels[0, 2] = 0.0                         # no bits
    w[0, 2] = -0.7                             # w * 0 = -0.0
    w[0, [3, 5, 8]] = 0.0                      # out of the round
    g[1, ::2] = 0.0
    levels[1, 1::4] = 0.0
    w[1] = rng.uniform(-1.0, 1.0, size=N_DEV)
    w[1, 3::4] = 0.0
    w[1, 3::4] *= -1.0                         # -0.0 weights
    w[2, 4] = 0.0
    u = rng.uniform(size=(T, N_DEV, D)).astype(np.float32)
    g = torch.from_numpy(g).to(tdt)
    m = g.abs().amax(-1)
    if nonfinite:
        w[0, 1] = np.inf                       # kept: inf * 0 is NaN
        w[0, 9] = 0.0                          # kept: safe * q may overflow
        levels[0, 9] = 1.0
        m[0, 9] = torch.finfo(tdt).max / 2
    lv = torch.from_numpy(levels).to(tdt)
    wt = torch.from_numpy(w).to(tdt)
    scal = torch.stack([m, lv, wt], -1)
    words = plain.quantize_pack_rows_ref(
        g.reshape(T * N_DEV, D), torch.from_numpy(u).reshape(T * N_DEV, D),
        scal[..., :2].reshape(T * N_DEV, 2), code_bits)
    return words.reshape(T, N_DEV, *words.shape[1:]), scal


@pytest.mark.parametrize("nonfinite", [False, True],
                         ids=["finite", "nonfinite"])
@pytest.mark.parametrize("code_bits", [4, 8, 16])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_skipping_silent_devices_changes_no_bit(dt, code_bits, nonfinite):
    words, scal = _inputs(dt, code_bits, nonfinite)
    ibits = DTYPES[dt][1]
    full = plain.packed_weighted_sum_ref(words, scal, code_bits, D)
    silent = _silent(scal, code_bits)
    assert int(silent[0].sum()) == (4 if nonfinite else 5)
    assert bool(silent[1].all())
    assert int(silent[2].sum()) == 1
    if nonfinite:
        assert not bool(silent[0, 1]) and not bool(silent[0, 9])
        assert bool(torch.isnan(full[0]).all())
    else:
        assert bool(torch.isfinite(full).all())
    for t in range(words.shape[0]):
        keep = ~silent[t]
        kept = plain.packed_weighted_sum_ref(words[t, keep][None],
                                             scal[t, keep][None], code_bits, D)
        assert torch.equal(kept[0].view(ibits), full[t].view(ibits)), t
    # every device silent: the sum is +0.0 to the bit, as the empty one
    assert not bool(full[1].view(ibits).any())


def test_code_from_bits_is_exact_for_every_16_bit_code():
    q = torch.arange(1 << 16, dtype=torch.int64)
    x = (q | 0x4330000000000000).view(torch.float64) - 2.0 ** 52
    assert torch.equal(x.view(torch.int64), q.to(torch.float64)
                       .view(torch.int64))
