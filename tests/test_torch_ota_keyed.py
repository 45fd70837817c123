"""The OTA epilogue's keyed entry (``repro_torch.kernels.ota_combine_keyed``,
the FL-LM collective's ``ops.ota_combine``) on CPU tensors.

On the CPU the wrapper takes its plain version, ``ref.ota_combine_keyed_ref``
(``rngstream.normal`` drawn with torch, then ``ota_combine_ref``); the CUDA
kernel, which draws the same threefry normals itself, is held bit-equal to
that on the card by ``chip_smoke.py``. What is compared, and how closely:

  * the wrapper and ``ops.ota_combine``'s two routes against the plain
    version, and the plain version against its composition written out:
    bit-equal (floats compared as integers);
  * the plain version against ``repro.kernels.ops.ota_combine`` (JAX's own
    ``jax.random.normal``): within 4 ulp of |g inv_alpha| + |z| (f32 ulps),
    the bound of ``test_torch_collectives.py``: the port's normals are
    within 3 ulp of JAX's, one more for the epilogue's own rounding; in f32
    and f64, and with the normals drawn across chunk edges.
"""
import numpy as np
import pytest
import torch

from _torch_reference import one_thread, ref  # noqa: F401  (fixtures)
from repro_torch import kernels
from repro_torch.core import rngstream
from repro_torch.kernels import ops, ota_combine, ota_combine_keyed
from repro_torch.kernels import ref as kref

pytestmark = pytest.mark.usefixtures("one_thread")

TYPES = {"f32": (np.float32, torch.float32),
         "f64": (np.float64, torch.float64)}
KEY = rngstream.split(rngstream.prng_key(2), 5)[4]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def _g(shape, dt, seed=9):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(TYPES[dt][0]))


@pytest.mark.parametrize("dt", list(TYPES))
@pytest.mark.parametrize("shape", [(1,), (3,), (7, 33), (2, 3, 1001)])
def test_wrapper_on_cpu_is_the_plain_version(dt, shape):
    g = _g(shape, dt)
    before = ota_combine_keyed.launches
    got = ota_combine_keyed(g, 0.4, 0.3, KEY)
    assert ota_combine_keyed.launches == before      # the CPU: no launch
    want = kref.ota_combine_keyed_ref(g, 0.4, 0.3, KEY)
    assert got.dtype == g.dtype and got.shape == g.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    # the plain version is the epilogue on the draw, written out
    z = (torch.tensor(0.3) * rngstream.normal(KEY, shape)).to(g.dtype)
    inv = torch.tensor([0.4], dtype=g.dtype)
    composed = kref.ota_combine_ref(g.reshape(1, -1), inv, z.reshape(1, -1))
    np.testing.assert_array_equal(_bits(want.numpy()),
                                  _bits(composed.reshape(shape).numpy()))


@pytest.mark.parametrize("dt", list(TYPES))
@pytest.mark.parametrize("noise_scale", [0.3, 0.0])
def test_ops_routes_give_the_same_bits(dt, noise_scale):
    """``use_kernel`` True and False give the same bits; with no noise the
    epilogue is exactly g * inv_alpha."""
    g = _g((5, 7, 11), dt)
    routes = [ops.ota_combine(g, torch.tensor(2.5), torch.tensor(noise_scale),
                              KEY, use_kernel=uk) for uk in (True, False)]
    np.testing.assert_array_equal(_bits(routes[0].numpy()),
                                  _bits(routes[1].numpy()))
    if noise_scale == 0.0:
        inv = (1.0 / torch.tensor(2.5, dtype=torch.float32)).to(g.dtype)
        np.testing.assert_array_equal(_bits(routes[0].numpy()),
                                      _bits((g * inv).numpy()))


def test_kernel_route_draws_no_normals_with_torch(monkeypatch):
    """On the kernel route ``ops.ota_combine`` hands the key to the keyed
    entry and makes no torch draw and no row-entry launch: both are
    replaced by traps here, and the keyed wrapper by a stand-in that
    returns the plain result made beforehand."""
    g = _g((4, 9), "f32")
    want = kref.ota_combine_keyed_ref(g, 0.4, 0.3, KEY)
    calls = []

    def keyed(g_, inv_alpha, scale, key):
        calls.append((inv_alpha, scale, tuple(key)))
        return want

    def trap(*args, **kw):
        raise AssertionError("the kernel route must not call this")

    monkeypatch.setattr(ops, "ota_combine_keyed", keyed)
    monkeypatch.setattr(ops, "ota_combine_kernel", trap)
    monkeypatch.setattr(rngstream, "normal", trap)
    out = ops.ota_combine(g, 2.5, 0.3, KEY)
    assert out is want
    assert calls == [(float(np.float32(1 / np.float32(2.5))),
                      float(np.float32(0.3)), KEY)]


@pytest.mark.parametrize("dt", list(TYPES))
@pytest.mark.parametrize("shape,chunk", [((3, 16, 40), None), ((1001,), None),
                                         ((3, 1001), 1000)])
def test_plain_version_within_4ulp_of_reference(ref, monkeypatch, dt, shape,
                                                chunk):
    """Against ``repro.kernels.ops.ota_combine``; with ``chunk`` the
    normals are drawn 1000 counters at a time, so (3, 1001) crosses three
    chunk edges, and the result is bit-equal to the draw in one chunk."""
    jax, jnp = ref.jax, ref.jax.numpy
    npdt, _ = TYPES[dt]
    g = _g(shape, dt).numpy()
    jkey = jax.random.split(jax.random.key(2), 5)[4]
    with jax.enable_x64(dt == "f64"):
        want = np.asarray(ref.ops.ota_combine(jnp.asarray(g),
                                              jnp.float32(2.5),
                                              jnp.float32(0.3), jkey))
        z = 0.3 * np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    whole = ops.ota_combine(torch.from_numpy(g), 2.5, 0.3, KEY,
                            use_kernel=False)
    if chunk:
        monkeypatch.setattr(rngstream, "UNIFORM_CHUNK", chunk)
    for use_kernel in (False, True):
        got = ops.ota_combine(torch.from_numpy(g), 2.5, 0.3, KEY,
                              use_kernel=use_kernel).numpy()
        assert got.dtype == npdt and got.shape == shape
        np.testing.assert_array_equal(_bits(got), _bits(whole.numpy()))
        scale = np.abs(g * 0.4).astype(np.float32) + np.abs(z)
        gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
        tol = 4.0 * np.spacing(scale.astype(np.float32))
        assert np.all(gap <= tol), float(np.max(gap / tol)) * 4.0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = torch.zeros(4, 6)
    with pytest.raises(TypeError):
        ota_combine_keyed(g.to(torch.bfloat16), 1.0, 0.1, KEY)
    with pytest.raises(TypeError):
        ota_combine_keyed(g.to(torch.float16), 1.0, 0.1, KEY)
    with pytest.raises(ValueError):
        ota_combine_keyed(g.t(), 1.0, 0.1, KEY)              # not contiguous
    with pytest.raises(ValueError):            # a scalar off the host
        ota_combine_keyed(g, torch.ones((), device="meta"), 0.1, KEY)
    with pytest.raises(ValueError):
        ota_combine_keyed(g, 1.0, torch.zeros(2), KEY)       # not one entry
    with pytest.raises(ValueError):            # a meta g is checked too
        ota_combine_keyed(torch.zeros(6, 4, device="meta").t(), 1.0, 0.1,
                          KEY)
    with pytest.raises(ValueError):
        ota_combine_keyed(g, 1.0, 0.1, (0, 1 << 32))
    launches = ota_combine_keyed.launches    # the CPU takes the plain version
    out = ota_combine_keyed(g, torch.tensor(1.0), 0.1, KEY)
    assert ota_combine_keyed.launches == launches and out.shape == g.shape


def test_launch_counters_name_the_two_entries_apart():
    assert ota_combine in kernels.KERNELS
    assert ota_combine_keyed in kernels.KERNELS
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    assert counts["ota_combine"] == counts["ota_combine_keyed"] == 0
    assert len(counts) == len(kernels.KERNELS)
    ota_combine_keyed.launches += 2
    try:
        counts = kernels.launch_counts()
        assert counts["ota_combine_keyed"] == 2
        assert counts["ota_combine"] == 0
    finally:
        kernels.reset_launch_counts()
    assert kernels.launch_counts()["ota_combine_keyed"] == 0
