"""The port's kernel callers (``repro_torch.kernels.ops``) on CPU tensors
against ``repro.kernels.ops`` with its Pallas kernels in interpret mode.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels themselves are held bit-equal to those on the card by
``chip_smoke.py``. Tolerances:
  * OTA epilogue: 1 ulp of |g*inv| + |z| — the
    reference's own slack (its kernel computes g*inv + z*inv where the
    math is (g + z)/alpha), and XLA may contract the two into an FMA;
  * quantizer: codes round((out + m)/safe) bit-equal, outputs within 1 ulp
    of the row scale m (the reference may contract -m + safe*q into an
    FMA);
  * weighted sum: 4 ulp of the result's magnitude (the matvec sums the
    devices in another order).
"""
import numpy as np
import pytest
import torch

from _torch_reference import ref  # noqa: F401  (module-scoped fixture)
from repro_torch.kernels import dithered_quantize_rows, ota_combine, ops

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                      torch.float32)}


def _assert_ulps(got, want, ulps=1.0, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    mag = np.abs(want) if scale is None else scale
    tol = ulps * np.spacing(mag.astype(want.dtype))
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol), \
        float(np.max(np.abs(got.astype(np.float64) - want) / tol))


def _ref_call(ref, f64: bool, fn):
    """Run a reference call in the precision the engine runs it in."""
    if f64:
        with ref.jax.enable_x64():
            return np.asarray(fn())
    return np.asarray(fn())


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("d", [1, 7, 650, 7850, 70001])
def test_ota_combine_with_noise_within_1ulp(ref, dt, d):
    npdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(d)
    g = rng.normal(size=d).astype(npdt) * 3
    noise = rng.normal(size=d).astype(npdt) * 1e-3
    alpha = 0.37 * (d % 5 + 1)
    jnp = ref.jax.numpy
    want = _ref_call(ref, dt == "f64", lambda: ref.ops.ota_combine_with_noise(
        jnp.asarray(g), alpha, jnp.asarray(noise), use_kernel=True))
    got = ops.ota_combine_with_noise(torch.from_numpy(g), alpha,
                                     torch.from_numpy(noise))
    assert got.dtype == tdt
    _assert_ulps(got.numpy(), want, scale=_addends(g, noise, alpha))


def _addends(g, noise, alpha):
    """|g*inv| + |z*inv|: the scale of the epilogue's two roundings."""
    return (np.abs(g) + np.abs(noise)) / np.abs(alpha)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_ota_combine_per_row_alpha_matches_row_calls(ref, dt):
    # Vanilla OTA's per-trial alpha: one inv_alpha per row of the launch
    npdt, _ = DTYPES[dt]
    rng = np.random.default_rng(1)
    g = rng.normal(size=(3, 650)).astype(npdt)
    noise = rng.normal(size=(3, 650)).astype(npdt)
    alpha = np.array([0.5, 3.0, 1e3])
    got = ops.ota_combine_with_noise(torch.from_numpy(g),
                                     torch.from_numpy(alpha),
                                     torch.from_numpy(noise)).numpy()
    jnp = ref.jax.numpy
    for r in range(3):
        want = _ref_call(ref, dt == "f64",
                         lambda: ref.ops.ota_combine_with_noise(
                             jnp.asarray(g[r]), jnp.asarray(alpha[r]),
                             jnp.asarray(noise[r]), use_kernel=True))
        _assert_ulps(got[r], want,
                     scale=_addends(g[r], noise[r], alpha[r]))


def test_ota_combine_bf16_payload_f32_accumulate(ref):
    rng = np.random.default_rng(2)
    g32 = rng.normal(size=(2, 1000)).astype(np.float32)
    noise = rng.normal(size=(2, 1000)).astype(np.float32)
    g_bf = torch.from_numpy(g32).to(torch.bfloat16)
    got = ops.ota_combine_with_noise(g_bf, 2.5, torch.from_numpy(noise),
                                     acc_dtype=torch.float32)
    assert got.dtype == torch.float32
    jnp = ref.jax.numpy
    want = np.asarray(ref.ops.ota_combine_with_noise(
        jnp.asarray(g32).astype(jnp.bfloat16), 2.5, jnp.asarray(noise),
        use_kernel=True, acc_dtype=jnp.float32))
    _assert_ulps(got.numpy(), want,
                 scale=_addends(g_bf.float().numpy(), noise, 2.5))


def _quant_inputs(npdt, n, d, seed):
    """Rows of mixed scale plus degenerate ones: row 1 all zero (m = 0),
    row 2 granted no bits (levels 0)."""
    rng = np.random.default_rng(seed)
    gs = (rng.normal(size=(n, d)) * rng.uniform(0.01, 5.0, size=(n, 1)))
    gs[1] = 0.0
    gs = gs.astype(npdt)
    levels = (2.0 ** rng.integers(1, 9, size=n) - 1.0)
    levels[2] = 0.0
    dither = rng.uniform(size=(n, d)).astype(np.float32)
    return gs, levels, dither


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("d", [7, 650, 1000, 7850])
def test_dithered_quantize_batch_codes_bit_equal(ref, dt, d):
    npdt, _ = DTYPES[dt]
    gs, levels, dither = _quant_inputs(npdt, 6, d, seed=d)
    jnp = ref.jax.numpy
    want = _ref_call(ref, dt == "f64", lambda: ref.ops.dithered_quantize_batch(
        jnp.asarray(gs), jnp.asarray(levels, npdt), jnp.asarray(dither),
        use_kernel=True))
    got = ops.dithered_quantize_batch(torch.from_numpy(gs),
                                      torch.from_numpy(levels),
                                      torch.from_numpy(dither)).numpy()
    m = np.max(np.abs(gs), axis=1, keepdims=True)
    _assert_ulps(got, want, scale=np.broadcast_to(m, gs.shape))
    assert np.all(got[1:3] == 0.0) and np.all(want[1:3] == 0.0)
    lv = levels.astype(npdt)[:, None]
    live = (m > 0) & (lv > 0)
    safe = np.where(live, 2.0 * m / np.where(lv > 0, lv, 1.0), 1.0)
    codes = lambda out: np.round((out.astype(np.float64) + m) / safe)
    np.testing.assert_array_equal(codes(got)[live[:, 0]],
                                  codes(want)[live[:, 0]])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_dithered_quantize_rows_wrapper_is_the_plain_version(dt):
    # CPU tensors take ref.dithered_quantize_rows_ref, unchanged
    npdt, _ = DTYPES[dt]
    gs, levels, dither = _quant_inputs(npdt, 4, 300, seed=3)
    g = torch.from_numpy(gs)
    m = g.abs().amax(1)
    lv = torch.from_numpy(levels.astype(npdt))
    out = dithered_quantize_rows(g, torch.from_numpy(dither),
                                 torch.stack([m, lv], 1))
    plain = ops.ref.dithered_quantize_rows_ref(g, torch.from_numpy(dither),
                                               m, lv)
    assert torch.equal(out, plain)
    assert dithered_quantize_rows.launches == 0


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("d", [650, 7850])
def test_quantized_weighted_sum_within_4ulp(ref, dt, d):
    npdt, _ = DTYPES[dt]
    gs, levels, dither = _quant_inputs(npdt, 8, d, seed=d + 1)
    weights = np.random.default_rng(d).uniform(0.0, 2.0, size=8).astype(npdt)
    jnp = ref.jax.numpy
    want = _ref_call(ref, dt == "f64", lambda: ref.ops.quantized_weighted_sum(
        jnp.asarray(gs), jnp.asarray(levels, npdt), jnp.asarray(dither),
        jnp.asarray(weights), r_max=8, use_kernel=True))
    got = ops.quantized_weighted_sum(
        torch.from_numpy(gs), torch.from_numpy(levels),
        torch.from_numpy(dither), torch.from_numpy(weights), r_max=8)
    _assert_ulps(got.numpy(), want, ulps=4.0,
                 scale=np.max(np.abs(want)))


def test_wrappers_reject_what_the_kernels_do_not_take():
    g = torch.zeros(2, 8, dtype=torch.float64)
    with pytest.raises(TypeError):
        ota_combine(g, torch.ones(2, dtype=torch.float64), g.float())
    with pytest.raises(ValueError):
        ota_combine(g, torch.ones(3, dtype=torch.float64), g)
    with pytest.raises(TypeError):
        dithered_quantize_rows(g, g, torch.ones(2, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        dithered_quantize_rows(g, g.float(), torch.ones(3, 2,
                                                        dtype=torch.float64))
    assert ota_combine.launches == 0
