"""The port's payload path (``repro_torch.kernels.payload`` and its callers
in ``ops``) on CPU tensors against ``repro.kernels.ops`` with its Pallas
payload kernels in interpret mode, on the same numpy-made inputs.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels are held bit-equal to those on the card by ``chip_smoke.py``.
What is compared, and how closely:

  * packed words: bit-equal on each device's common prefix (the reference
    pads further, to its row tile);
  * decoded floats: codes bit-equal; the floats within 1 ulp of the row
    scale m. The reference's XLA lowering contracts ``-m + safe*q`` into
    an FMA in most layouts (in f32 every decoded float it gives equals
    either the separately rounded value or the FMA's, checked exactly
    below); the port keeps the multiply and add apart, so that the packed
    route decodes bit-equal to the two-step quantizer;
  * the fused weighted sum: exactly the port's sequential plain version;
    against the reference's, within 4 ulp of S = sum_i |w_i| (|v_i| +
    m_i), the size of the terms the two roundings act on. Measured worst
    case 1.0 ulp of S. Against sum_i |w_i v_i| alone the gap reaches
    30 ulp (f32, code_bits 16, d = 5000), where -m and safe*q cancel.
"""
import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch import interop
from repro_torch.kernels import (dithered_quantize_rows, ops, payload,
                                 packed_weighted_sum, quantize_pack_rows,
                                 ref as plain, unpack_dequant_rows)

DTYPES = {"f64": (np.float64, torch.float64),
          "f32": (np.float32, torch.float32)}
CASES = [(dt, cb, d) for dt in ("f64", "f32") for cb in (4, 8, 16)
         for d in (1000, 5000, 131073)]
IDS = [f"{dt}-cb{cb}-d{d}" for dt, cb, d in CASES]
N_DEV = 5


def _inputs(npdt, cb, d, n=N_DEV, seed=0):
    """Rows of mixed scale and bit width, plus degenerate ones: row 1 all
    zero (m = 0), row 2 granted no bits (levels 0)."""
    rng = np.random.default_rng([d, cb, seed])
    gs = rng.normal(size=(n, d)) * rng.uniform(0.01, 5.0, size=(n, 1))
    gs[1] = 0.0
    levels = 2.0 ** rng.integers(1, cb + 1, size=n) - 1.0
    levels[2] = 0.0
    dither = rng.uniform(size=(n, d)).astype(np.float32)
    weights = rng.uniform(0.0, 2.0, size=n)
    return gs.astype(npdt), levels, dither, weights.astype(npdt)


@pytest.fixture(scope="module")
def reference(ref):
    """Reference words, decoded floats and fused sum per case, computed
    once per case (in the precision the engine runs them in)."""
    jnp, cache = ref.jax.numpy, {}

    def get(dt, cb, d):
        if (dt, cb, d) not in cache:
            npdt = DTYPES[dt][0]
            gs, levels, dither, w = _inputs(npdt, cb, d)
            with ref.jax.enable_x64(dt == "f64"):
                pk = ref.ops.quantize_pack(jnp.asarray(gs),
                                           jnp.asarray(levels, npdt),
                                           jnp.asarray(dither), code_bits=cb)
                cache[dt, cb, d] = dict(
                    pk=pk, deq=np.asarray(ref.ops.unpack_dequant(pk)),
                    wsum=np.asarray(ref.ops.packed_weighted_sum(
                        pk, jnp.asarray(w))))
        return cache[dt, cb, d]

    return get


def _port_pack(dt, cb, d):
    gs, levels, dither, w = _inputs(DTYPES[dt][0], cb, d)
    pk = ops.quantize_pack(torch.from_numpy(gs), torch.from_numpy(levels),
                           torch.from_numpy(dither), code_bits=cb)
    return pk, gs, levels, dither, w


def _row_step(gs, levels):
    """(valid, safe, m) per row, as both quantizers compute them."""
    m = np.max(np.abs(gs), axis=1, keepdims=True)
    lv = levels.astype(gs.dtype)[:, None]
    valid = (m > 0) & (lv > 0)
    safe = np.where(valid, (2.0 * m).astype(gs.dtype)
                    / np.where(lv > 0, lv, 1.0).astype(gs.dtype), 1.0)
    return valid, safe.astype(gs.dtype), m


@pytest.mark.parametrize("dt,cb,d", CASES, ids=IDS)
def test_pack_words_bit_equal_to_reference(reference, dt, cb, d):
    pk, *_ = _port_pack(dt, cb, d)
    w_rows = plain.payload_word_rows(d, cb)
    assert pk.words.shape == (N_DEV, w_rows, plain.LANES)
    assert pk.words.dtype == torch.int32
    want = np.asarray(reference(dt, cb, d)["pk"].words).view(np.int32)
    want = want.reshape(N_DEV, -1, plain.LANES)[:, :w_rows]
    np.testing.assert_array_equal(pk.words.numpy(), want)
    assert not pk.words[1:3].any()          # degenerate rows code to 0


@pytest.mark.parametrize("dt,cb,d", CASES, ids=IDS)
def test_unpack_dequant_matches_reference(reference, dt, cb, d):
    pk, gs, levels, _, _ = _port_pack(dt, cb, d)
    got = ops.unpack_dequant(pk).numpy()
    want = reference(dt, cb, d)["deq"]
    assert got.shape == want.shape == (N_DEV, d) and got.dtype == want.dtype
    valid, safe, m = _row_step(gs, levels)
    codes = plain._unpack_codes(pk.words, cb, d).numpy()
    np.testing.assert_array_equal(
        np.round((want.astype(np.float64) + m) / safe)[valid[:, 0]],
        codes[valid[:, 0]])
    assert np.all(got[~valid[:, 0]] == 0) and np.all(want[~valid[:, 0]] == 0)
    ulp_m = np.spacing(np.where(valid, m, 1.0).astype(gs.dtype))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp_m)
    if dt == "f32":
        # f32 * a 16-bit code and - m are exact in f64: one rounding of
        # that is the FMA's result
        fma = np.where(valid, (safe.astype(np.float64) * codes
                               - m.astype(np.float64)).astype(np.float32), 0)
        assert np.all((want == got) | (want == fma))


@pytest.mark.parametrize("dt,cb,d", CASES, ids=IDS)
def test_unpack_of_pack_is_the_two_step_quantizer(dt, cb, d):
    pk, gs, levels, dither, _ = _port_pack(dt, cb, d)
    two_step = ops.dithered_quantize_batch(torch.from_numpy(gs),
                                           torch.from_numpy(levels),
                                           torch.from_numpy(dither))
    assert torch.equal(ops.unpack_dequant(pk), two_step)


@pytest.mark.parametrize("dt,cb,d", CASES, ids=IDS)
def test_packed_weighted_sum_within_4ulp_of_reference(reference, dt, cb, d):
    pk, gs, levels, _, w = _port_pack(dt, cb, d)
    got = ops.packed_weighted_sum(pk, torch.from_numpy(w)).numpy()
    want = reference(dt, cb, d)["wsum"]
    assert got.shape == want.shape == (d,) and got.dtype == want.dtype
    valid, _, m = _row_step(gs, levels)
    v = ops.unpack_dequant(pk).numpy()
    scale = np.sum(np.abs(w[:, None]) * (np.abs(v) + np.where(valid, m, 0)),
                   axis=0)
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= 4 * np.spacing(scale.astype(gs.dtype))), \
        float(np.max(err / np.spacing(scale.astype(gs.dtype))))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("cb", [4, 8, 16])
def test_packed_weighted_sum_is_the_sequential_plain_version(dt, cb):
    # three trials of N_DEV devices in one launch, against the unpacked
    # sequential oracle acc + w_i * quantize(g_i) trial by trial
    _, tdt = DTYPES[dt]
    ins = [_inputs(DTYPES[dt][0], cb, 3000, seed=k) for k in range(3)]
    g, lv, u, w = (torch.from_numpy(np.stack(a)) for a in zip(*ins))
    pk = ops.quantize_pack(g, lv, u, code_bits=cb)
    assert pk.words.shape[:2] == (3, N_DEV)
    got = ops.packed_weighted_sum(pk, w)
    assert got.shape == (3, g.shape[-1]) and got.dtype == tdt
    scal3 = torch.stack([g.abs().amax(-1), lv.to(tdt), w], dim=-1)
    assert torch.equal(got, plain.quantized_weighted_sum_ref(g, u, scal3))
    for t in range(3):
        one = ops.quantize_pack(g[t], lv[t], u[t], code_bits=cb)
        assert torch.equal(ops.packed_weighted_sum(one, w[t]), got[t])


def test_degenerate_or_absent_device_contributes_exactly_zero():
    # device 1 is all zero (m = 0), device 2 has no bits, device 3 is out
    # of the round (weight 0): the sum equals the one over devices 0 and 4
    gs, levels, dither, w = _inputs(np.float64, 8, 5000)
    w[3] = 0.0
    pk = ops.quantize_pack(torch.from_numpy(gs), torch.from_numpy(levels),
                           torch.from_numpy(dither), code_bits=8)
    got = ops.packed_weighted_sum(pk, torch.from_numpy(w))
    keep = [0, 4]
    sub = ops.quantize_pack(torch.from_numpy(gs[keep]),
                            torch.from_numpy(levels[keep]),
                            torch.from_numpy(dither[keep]), code_bits=8)
    assert torch.equal(got, ops.packed_weighted_sum(
        sub, torch.from_numpy(w[keep])))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n,d", [(8, 200000), (5, 131073)])
def test_quantized_weighted_sum_fuses_as_the_reference(ref, monkeypatch, dt,
                                                       n, d):
    npdt, _ = DTYPES[dt]
    gs, levels, dither, w = _inputs(npdt, 8, d, n=n)
    jnp = ref.jax.numpy
    with ref.jax.enable_x64(dt == "f64"):
        want = np.asarray(ref.ops.quantized_weighted_sum(
            jnp.asarray(gs), jnp.asarray(levels, npdt), jnp.asarray(dither),
            jnp.asarray(w), r_max=8, use_kernel=True))
    packed = []
    real = payload.quantize_pack_rows
    monkeypatch.setattr(payload, "quantize_pack_rows",
                        lambda *a: packed.append(a[-1]) or real(*a))
    got = ops.quantized_weighted_sum(
        torch.from_numpy(gs), torch.from_numpy(levels),
        torch.from_numpy(dither), torch.from_numpy(w), r_max=8).numpy()
    assert packed == [8]                    # the fused route, 8-bit codes
    valid, _, m = _row_step(gs, levels)
    v = np.asarray(ops.dithered_quantize_batch(
        torch.from_numpy(gs), torch.from_numpy(levels),
        torch.from_numpy(dither)))
    scale = np.sum(np.abs(w[:, None]) * (np.abs(v) + np.where(valid, m, 0)),
                   axis=0)
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= 4 * np.spacing(scale.astype(npdt)))


def test_quantized_weighted_sum_dispatch_rules(monkeypatch):
    packed = []
    real = payload.quantize_pack_rows
    monkeypatch.setattr(payload, "quantize_pack_rows",
                        lambda *a: packed.append(a[-1]) or real(*a))
    gs, levels, dither, w = (torch.from_numpy(a) for a in
                             _inputs(np.float64, 4, 1000, n=4))
    big = [torch.from_numpy(a) for a in _inputs(np.float64, 4, 1 << 17, n=3)]
    call = ops.quantized_weighted_sum
    call(gs, levels, dither, w, r_max=4)             # d < 2^17: two-step
    call(*big, r_max=17)                             # no code width fits
    call(*big, r_max=4, use_kernel=False)            # plain: two-step
    assert packed == []
    call(*big, r_max=3)                              # d >= 2^17: 4-bit codes
    call(gs, levels, dither, w, r_max=12, fused=True)
    assert packed == [4, 16]
    # use_kernel=False with fused=True: the sequential plain version, the
    # same bits as the packed route
    seq = call(gs, levels, dither, w, r_max=4, fused=True, use_kernel=False)
    assert packed == [4, 16]
    assert torch.equal(seq, call(gs, levels, dither, w, r_max=4, fused=True))
    with pytest.raises(ValueError, match="r_max"):
        call(gs, levels, dither, w, fused=True)


def test_packed_grads_carry_across_from_the_reference(reference):
    pk_r = reference("f64", 8, 5000)["pk"]
    pk_p = interop.packed_grads(pk_r)
    mine, *_ = _port_pack("f64", 8, 5000)
    assert (pk_p.code_bits, pk_p.d) == (8, 5000)
    assert torch.equal(pk_p.words, mine.words)
    assert torch.equal(pk_p.scal, mine.scal)
    assert torch.equal(ops.unpack_dequant(pk_p), ops.unpack_dequant(mine))


def test_wrappers_reject_what_the_kernels_do_not_take():
    g = torch.zeros(2, 300, dtype=torch.float64)
    u = torch.zeros(2, 300)
    scal = torch.ones(2, 2, dtype=torch.float64)
    words = quantize_pack_rows(g, u, scal, 8)
    assert words.shape == (2, 1, 128)
    with pytest.raises(TypeError):
        quantize_pack_rows(g, g, scal, 8)               # f64 dither
    with pytest.raises(TypeError):
        quantize_pack_rows(g.half(), u, scal.half(), 8)
    with pytest.raises(ValueError, match="code_bits"):
        quantize_pack_rows(g, u, scal, 12)
    with pytest.raises(ValueError):
        quantize_pack_rows(g, u, scal[:1], 8)
    with pytest.raises(TypeError):
        unpack_dequant_rows(words.long(), scal, 8, 300)
    with pytest.raises(ValueError):
        unpack_dequant_rows(words, scal, 8, 600)        # W is for d = 300
    scal3 = torch.ones(1, 2, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        packed_weighted_sum(words, scal3, 8, 300)       # words not 4-d
    with pytest.raises(ValueError):
        packed_weighted_sum(words[None], scal3[..., :2], 8, 300)
    assert torch.equal(packed_weighted_sum(words[None], scal3, 8, 300),
                       plain.packed_weighted_sum_ref(words[None], scal3, 8,
                                                     300))
    # the CPU takes the plain versions and launches nothing
    assert (quantize_pack_rows.launches, unpack_dequant_rows.launches,
            packed_weighted_sum.launches,
            dithered_quantize_rows.launches) == (0, 0, 0, 0)
